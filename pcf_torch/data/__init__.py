"""Host-side input pipeline: synthetic scenes, the pyramid (native library or
numpy/scipy), augmentations and the ScanNet loaders (data/scannet.py)."""

from pcf_torch.data.pyramid import compute_knn, scene_to_item, subsample, subsample_and_knn
from pcf_torch.data.synthetic import synthetic_scene
