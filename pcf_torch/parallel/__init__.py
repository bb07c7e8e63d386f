"""The steps, on one device or a data mesh (mesh.py), and their CUDA graphs
(graphs.py).

The steps are imported at first use, so that graphs.py can be imported
without the model code (serve/export.ServingModel replays graphs of
exported programs)."""

_STEPS = ("make_eager_eval_step", "make_eager_train_step", "make_eval_step",
          "make_mesh", "make_train_step", "step_seed")


def __getattr__(name):
    if name in _STEPS:
        from pcf_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module 'pcf_torch.parallel' has no attribute {name!r}")
