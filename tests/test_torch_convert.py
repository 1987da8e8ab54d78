"""Weight loading: the port's `load_npz` / `params_from_jax` against the
JAX package's `load_from_npz`, on the trained fixture."""

import os

import numpy as np
import pytest
import torch

from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


def _leaves(tree, prefix=""):
    """{'joints/lstm/0/fwd/w_ih': array, ...} from a nested dict/list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def test_load_npz_matches_jax_loader():
    want, got = load_from_npz(_FIXTURE), load_npz(_FIXTURE)
    assert isinstance(got["joints"]["lstm"], list)
    w, g = _leaves(want), _leaves(got)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_params_from_jax_keeps_every_array():
    tree = load_npz(_FIXTURE)
    params = params_from_jax(tree, device="cpu")
    leaves = _leaves(tree)
    port = {}
    for name, block in params.items():
        for pname, p in block.named_parameters():
            assert p.dtype == torch.float32 and not p.requires_grad
            # linear1.weight [out, in] is the JAX linear1/w [in, out]
            key = (pname.replace(".weight", "/w").replace(".bias", "/b")
                   .replace(".", "/"))
            port[f"{name}/{key}"] = p
    assert sorted(port) == sorted(leaves)
    for k, arr in leaves.items():
        want = arr.astype(np.float32)
        got = port[k].numpy()
        np.testing.assert_array_equal(got.T if k.endswith("/w") else got,
                                      want, err_msg=k)


def test_params_from_jax_rejects_out_of_slice_weights():
    tree = load_npz(_FIXTURE)
    w_hh = tree["velocity"]["lstm"][0]["fwd"]["w_hh"]
    tree["velocity"]["lstm"][0]["fwd"]["w_hh"] = w_hh.astype(np.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_jax(tree, device="cpu")
    tree["velocity"]["lstm"][0]["fwd"]["w_hh"] = w_hh[:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        params_from_jax(load_npz(_FIXTURE), device="cpu",
                        dtype=torch.bfloat16)
