"""Checkpoint reading (flax msgpack, without flax or msgpack)."""
