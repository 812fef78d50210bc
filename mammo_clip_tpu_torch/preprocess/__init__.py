"""Offline preprocessing of the port (host code: numpy, the standard library and
a small C++ library built with g++; no device op runs here): breast crop,
native normalize / crop / resize / CLAHE and their plain versions, the DICOM
codec and pool, packed shards, the DICOM tool, and the report and VinDr CSV
builders. It imports nothing of JAX, pandas, cv2, PIL or transformers."""

from .breast_crop import breast_roi_bounds, extract_breast_roi, remap_boxes
from .shard_writer import write_packed_shards
