"""The steps, on one device, a data mesh (mesh.py) or with the points
sharded (spatial.py), and their CUDA graphs (graphs.py).

The steps are imported at first use, so that graphs.py can be imported
without the model code (serve/export.ServingModel replays graphs of
exported programs)."""

_STEPS = {"make_eager_eval_step": "mesh", "make_eager_train_step": "mesh",
          "make_eval_step": "mesh", "make_mesh": "mesh", "make_mesh_2d": "mesh",
          "make_train_step": "mesh", "step_seed": "mesh",
          "make_spatial_eval_step": "spatial", "make_spatial_train_step": "spatial",
          "spatial_eval_forward": "spatial"}


def __getattr__(name):
    if name in _STEPS:
        import importlib

        return getattr(importlib.import_module(f"pcf_torch.parallel.{_STEPS[name]}"), name)
    raise AttributeError(f"module 'pcf_torch.parallel' has no attribute {name!r}")
