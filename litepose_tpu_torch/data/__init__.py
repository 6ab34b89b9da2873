"""Affine transforms and the resize ladder, dataset tables, synthetic
scenes and the training input pipeline, without cv2."""
