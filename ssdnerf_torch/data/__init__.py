from .builder import build_dataset, collate, register_dataset
from .shapenet_srn import ShapeNetSRN, load_intrinsics, load_pose

__all__ = ['ShapeNetSRN', 'build_dataset', 'collate', 'load_intrinsics',
           'load_pose', 'register_dataset']
