from .builder import DataLoader, build_dataset, collate, register_dataset
from .shapenet_srn import ShapeNetSRN, load_intrinsics, load_pose

__all__ = ['DataLoader', 'ShapeNetSRN', 'build_dataset', 'collate',
           'load_intrinsics', 'load_pose', 'register_dataset']
