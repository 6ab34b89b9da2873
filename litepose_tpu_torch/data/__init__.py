"""Dataset tables the serving slice needs (no cv2)."""
