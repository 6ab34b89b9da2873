"""Training: optimizers and LR schedules, the train step and epoch loop,
and checkpoints (flax msgpack, read and written without flax or
msgpack)."""
