"""The weights of a run: drawn from the seed on the device in one call, by
the reference's parameter names, and handed to both sides.

`draw` makes one uniform tensor for every parameter of the reference model
with a torch.Generator on the run's device, and scales each slice to the
parameter's range (reference/model.init_bounds). `to_program` maps them
onto the program's state dict: the same names, except that the program's
fused layers keep their output linear as `<layer>.linear.weight`
[in, out] and `<layer>.linear.bias`, where the reference has
`<layer>.linear.c.weight` [out, in] and `<layer>.linear.c.bias`.
"""

from __future__ import annotations

import torch

from perfbench.reference.model import Segmentation, init_bounds


def draw(cfg, seed: int, device) -> dict:
    """{reference parameter name: tensor on `device`} from `seed`."""
    with torch.device("meta"):
        ref = Segmentation(cfg)
    shapes = {n: p.shape for n, p in ref.named_parameters()}
    bounds = init_bounds(ref)
    total = sum(s.numel() for s in shapes.values())
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        lo, hi = bounds[name]
        out[name] = (flat[at:at + shape.numel()] * (hi - lo) + lo).reshape(shape)
        at += shape.numel()
    return out


def program_name(name: str, program_keys) -> tuple[str, bool]:
    """(the program's key of reference parameter `name`, whether it is
    stored transposed there)."""
    if name in program_keys:
        return name, False
    for ref_end, prog_end, t in ((".linear.c.weight", ".linear.weight", True),
                                 (".linear.c.bias", ".linear.bias", False)):
        if name.endswith(ref_end):
            alt = name[: -len(ref_end)] + prog_end
            if alt in program_keys:
                return alt, t
    raise KeyError(f"the program's model has no parameter for {name}")


def to_program(weights: dict, model: torch.nn.Module) -> dict:
    """Load `weights` into the program's model in place; returns
    {reference name: (program name, transposed)}. Every parameter of the
    program must receive one."""
    params = dict(model.named_parameters())
    mapping, seen = {}, set()
    with torch.no_grad():
        for name, w in weights.items():
            pname, t = program_name(name, params)
            src = w.t() if t else w
            if params[pname].shape != src.shape:
                raise ValueError(f"{name} -> {pname}: shape {tuple(src.shape)} against "
                                 f"{tuple(params[pname].shape)}")
            params[pname].copy_(src)
            mapping[name] = (pname, t)
            seen.add(pname)
    missing = set(params) - seen
    if missing:
        raise ValueError(f"program parameters with no weight: {sorted(missing)[:5]}")
    return mapping


def load_reference(weights: dict, model: torch.nn.Module) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
