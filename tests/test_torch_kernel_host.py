"""Host-side logic of the port's kernels that runs without a card: kernel E's
packed weights (their layout and the cache that keeps them between calls).

The kernels themselves are held against their plain versions on the card
(tests/test_torch_kernels_gpu.py)."""

import numpy as np
import pytest
import torch

from pcf_torch.ops.kernels.layer_eval import packed_weights


def _pairs(rng, dims):
    return [(torch.from_numpy(rng.standard_normal((ci, co)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal(co).astype(np.float32)))
            for ci, co in zip(dims, dims[1:])]


def _layer(seed=0):
    """Folded weights of a small guided layer: WeightNet 12-8-8-3, PE 12-5,
    guidance (4+5)-6-2, linear [Cx*W, O] = [8*3, 13]."""
    rng = np.random.default_rng(seed)
    wn, pe, gd = _pairs(rng, [12, 8, 8, 3]), _pairs(rng, [12, 5]), _pairs(rng, [9, 6, 2])
    lw = torch.from_numpy(rng.standard_normal((24, 13)).astype(np.float32))
    lb = torch.from_numpy(rng.standard_normal(13).astype(np.float32))
    return wn, pe, gd, lw, lb


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packed_weights_layout(bf16):
    """Each MLP layer at its descriptor's offsets: w [din, dp] then b [dp],
    zero-padded to dp columns (a power of two, at least 4), offsets
    multiples of 4 floats, the weights rounded to bf16 for a bf16 table (the
    biases stay f32); L the f32 weight, or its bf16 copy padded to 8
    columns."""
    wn, pe, gd, lw, lb = _layer()
    pk = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert pk.params.dtype == torch.float32 and pk.params.numel() % 4 == 0
    for pairs, d in zip((wn, pe, gd), pk.mlps):
        assert d.n == len(pairs)
        for i, (w, b) in enumerate(pairs):
            din, dout = w.shape
            dp = {2: 4, 3: 4, 5: 8, 6: 8, 8: 8}[dout]
            assert (d.din[i], d.dout[i]) == (din, dout) and d.w[i] % 4 == 0 == d.b[i] % 4
            got_w = pk.params[d.w[i]:d.w[i] + din * dp].reshape(din, dp)
            want_w = w.bfloat16().float() if bf16 else w
            assert torch.equal(got_w[:, :dout], want_w)
            assert not got_w[:, dout:].any()
            got_b = pk.params[d.b[i]:d.b[i] + dp]
            assert torch.equal(got_b[:dout], b) and not got_b[dout:].any()
    if bf16:
        assert pk.L.dtype == torch.bfloat16 and pk.L.shape == (24, 16)
        assert torch.equal(pk.L[:, :13], lw.bfloat16()) and not pk.L[:, 13:].any()
    else:
        assert torch.equal(pk.L, lw)
    assert torch.equal(pk.bias, lb)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packed_weights_cache_follows_updates(bf16):
    """A second call with the same tensors packs nothing; an in-place update
    of any folded tensor (its _version) packs again, with the new values;
    the f32 and bf16 forms are kept apart."""
    wn, pe, gd, lw, lb = _layer(1)
    first = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert packed_weights(wn, pe, gd, lw, lb, bf16) is first
    other = packed_weights(wn, pe, gd, lw, lb, not bf16)
    assert other is not first and packed_weights(wn, pe, gd, lw, lb, bf16) is first

    lw.mul_(2.0)
    second = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert second is not first
    want = lw.bfloat16() if bf16 else lw
    assert torch.equal(second.L[:, :13], want)

    gd[0][0].add_(1.0)
    third = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert third is not second
    d = third.mlps[2]
    got = third.params[d.w[0]:d.w[0] + 9 * 8].reshape(9, 8)[:, :6]
    assert torch.equal(got, gd[0][0].bfloat16().float() if bf16 else gd[0][0])
    assert packed_weights(wn, pe, gd, lw, lb, bf16) is third
