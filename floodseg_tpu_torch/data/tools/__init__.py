"""Dataset tools (counterpart of floodseg_tpu/data/tools/): ``make_flow``
builds the list files of a labeled tree, ``extract_motion_vectors`` a
video's frames and block motion-vector grids. Host-only; they need none of
PIL, pandas, cv2 or mvextractor to import."""
