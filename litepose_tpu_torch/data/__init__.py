"""Affine transforms and the resize ladder, dataset tables and synthetic
scenes, without cv2."""
