"""Data of the evaluation path: COCO-layout datasets, the image folder of
the submission harness, the synthetic set, and image files without cv2."""
