"""Evaluation entry points and their output writers."""

from pcf_torch.eval.io import NYU40_COLORMAP, remap_20_to_nyu40, write_labels_txt, write_ply_color
