"""File formats of the port: PCD clouds, epoch folders, result tables."""
from .pcd import read_pcd, write_pcd
from .folders import scan_epoch_folder, extract_time_from_filename
from . import formats

__all__ = ["read_pcd", "write_pcd", "scan_epoch_folder",
           "extract_time_from_filename", "formats"]
