"""Affine transforms and the resize ladder, COCO annotation IO, JPEG
decoding, OKS evaluation, datasets on disk, synthetic scenes and the
training input pipeline, without cv2."""
