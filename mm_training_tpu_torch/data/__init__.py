from .aimotive_dataset import AiMotiveDataset, collate_aim, get_frames
from .fake_batch import make_fake_batch, random_bda_matrices
from .formats import Annotation, CameraParams, Sequence, object_to_array
from .frame_loader import FrameData, FrameLoader
from .nuscenes_dataset import NUSC_CLASSES, NuscMVDetDataset
from .synthetic import generate_synthetic_dataset

__all__ = ['AiMotiveDataset', 'Annotation', 'CameraParams', 'FrameData', 'FrameLoader',
           'NUSC_CLASSES', 'NuscMVDetDataset', 'Sequence', 'collate_aim',
           'generate_synthetic_dataset', 'get_frames', 'make_fake_batch', 'object_to_array',
           'random_bda_matrices']
