"""The fused optimizer step (`ops/csrc/optax_adam.cu`) built with g++
against the CPU stand-in of the CUDA runtime (`tests/cuda_emu/`, whose
`cuda_bf16.h` rounds as the card does) and run on the CPU through
`OptaxAdam.step`'s CUDA route: the tensors handed to
`ops.optax_adam_cuda.optax_adam` report a CUDA device, so the wrapper
packs their pointers and launches the stand-in's kernel.

Each case runs three steps of `make_optimizer`'s optimizer on bf16 params
that way and, on a copy of the same params and gradients, on the CPU (the
plain chain of torch ops), and holds params and moments bit for bit: the
four modules at their shapes (joints with AdamW's decay, footcontact with
a 2-element tensor, off the 8-element vector), tensors without a
gradient (skipped), gradients at unaligned offsets of one buffer (the
element-by-element path), more tensors than one launch takes, and one
case also held to jitted optax within 1 bf16 ulp of each parameter's
magnitude, as `tests/test_torch_train_bf16.py` holds the plain chain, and
so a case of AdamW at a weight decay large enough to move bf16 params.
"""

import contextlib
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobileposer_tpu_torch.ops import optax_adam_cuda
from mobileposer_tpu_torch.train import trainer
from test_torch_cuda_emulation import _emu_build

BF16 = torch.bfloat16
STEPS = 3
LR = 1e-3
DECAY = 0.5


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def adam_lib(tmp_path_factory):
    return optax_adam_cuda.declare(_emu_build(tmp_path_factory,
                                              "optax_adam.cu"))


@pytest.fixture
def on_card(monkeypatch, adam_lib):
    """A context in which `OptaxAdam`'s updates take the stand-in's
    kernel, at a grid of 3 blocks (each strides over many chunks), with a
    fresh launch counter (`.launches`)."""
    real = optax_adam_cuda.optax_adam

    def route(params, grads, mus, nus, consts, decay):
        card = [[t.as_subclass(_OnCard) for t in ts]
                for ts in (params, grads, mus, nus)]
        real(*card, consts, decay)

    @contextlib.contextmanager
    def use():
        with monkeypatch.context() as m:
            m.setattr(optax_adam_cuda, "optax_adam", route)
            yield

    use.launches = dict.fromkeys(optax_adam_cuda.launches, 0)
    monkeypatch.setattr(optax_adam_cuda, "_lib", lambda: adam_lib)
    monkeypatch.setattr(optax_adam_cuda, "_max_blocks", lambda index: 3)
    monkeypatch.setattr(optax_adam_cuda, "launches", use.launches)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))
    return use


def _module(case: str):
    """(module name for `make_optimizer`, bf16 params) of a case."""
    if case in trainer.MODULE_NAMES or case in ("grad_none", "unaligned"):
        name = {"grad_none": "footcontact", "unaligned": "velocity"}.get(
            case, case)
        return name, trainer.init_train_state(
            name, torch.Generator().manual_seed(7), LR, "cpu", BF16).params
    rng = np.random.RandomState(5)
    sizes = ({"w": (16, 64), "b": (13,)} if case in ("optax", "decay") else
             {f"t{i}": (i + 1,) for i in range(optax_adam_cuda.MAX_TENSORS
                                               + 8)})
    return "joints", torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(rng.uniform(
            -0.0625, 0.0625, s).astype(np.float32)).to(BF16))
        for k, s in sizes.items()})


def _grads(rng, params, case):
    """One step's bf16 gradients (None for every third tensor in
    'grad_none'; views at odd offsets of one buffer in 'unaligned')."""
    gs = [torch.from_numpy((rng.randn(*p.shape) * 10.0 ** rng.uniform(
        -4, 0, p.shape)).astype(np.float32)).to(BF16) for p in params]
    if case == "grad_none":
        return [None if i % 3 == 1 else g for i, g in enumerate(gs)]
    if case == "unaligned":
        flat = torch.empty(1 + sum(g.numel() + 1 for g in gs), dtype=BF16)
        out, off = [], 1
        for g in gs:
            view = flat[off:off + g.numel()].view_as(g)
            view.copy_(g)
            out.append(view)
            off += g.numel() + 1
        assert any(g.data_ptr() % 16 for g in out)
        return out
    return gs


def _bits(t):
    return t.detach().view(torch.int16)


def _optimizer(case, name, params):
    """`make_optimizer`'s, or in 'decay' AdamW's term at a weight decay
    that moves bf16 params (at joints' 1e-4 it is mostly rounded away)."""
    if case == "decay":
        return trainer.OptaxAdam(params.parameters(), lr=LR,
                                 weight_decay=DECAY)
    return trainer.make_optimizer(name, LR, params)


def _optax_step(case, name):
    opt = (optax.adamw(LR, weight_decay=DECAY) if case == "decay" else
           optax.adamw(LR) if name == "joints" else optax.adam(LR))

    @jax.jit
    def step(params, state, g):
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state
    return opt, step


@pytest.mark.parametrize("case", ["poser", "joints", "footcontact",
                                  "velocity", "grad_none", "unaligned",
                                  "many_tensors", "optax", "decay"])
def test_fused_step_matches_the_plain_step(on_card, case):
    name, fused_params = _module(case)
    plain_params = copy.deepcopy(fused_params)
    fused = _optimizer(case, name, fused_params)
    plain = _optimizer(case, name, plain_params)
    assert isinstance(fused, trainer.OptaxAdam)
    fps, pps = list(fused_params.parameters()), list(plain_params.parameters())
    before = [p.detach().clone() for p in fps]
    held_to_optax = case in ("optax", "decay")
    if held_to_optax:
        opt, jstep = _optax_step(case, name)
        jparams = [jnp.asarray(p.detach().float().numpy()).astype(
            jnp.bfloat16) for p in fps]
        jstate = opt.init(jparams)
    rng = np.random.RandomState(11)
    per_step = -(-len(fps) // optax_adam_cuda.MAX_TENSORS)
    for k in range(STEPS):
        grads = _grads(rng, fps, case)
        for p, q, g in zip(fps, pps, grads):
            p.grad = g
            q.grad = None if g is None else g.clone()
        with on_card():
            fused.step()
        plain.step()
        assert on_card.launches["optax_adam_bf16"] == per_step * (k + 1)
        for i, (p, q) in enumerate(zip(fps, pps)):
            assert torch.equal(_bits(p), _bits(q)), (case, k, i)
            if q in plain.state:
                for m in ("mu", "nu"):
                    assert fused.state[p][m].dtype == BF16
                    assert torch.equal(_bits(fused.state[p][m]),
                                       _bits(plain.state[q][m])), (m, i)
                assert fused.state[p]["step"] == k + 1
        if held_to_optax:
            jparams, jstate = jstep(jparams, jstate, [
                jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
                for g in grads])
            for p, w in zip(fps, jparams):
                want = torch.from_numpy(np.array(w.astype(jnp.float32)))
                ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(
                    2.0 ** -126))) - 7)
                assert float(((p.detach().float() - want).abs() / ulp
                              ).max()) <= 1
    for i, (p, p0) in enumerate(zip(fps, before)):
        if case == "grad_none" and i % 3 == 1:
            assert p not in fused.state and torch.equal(_bits(p), _bits(p0))
        else:
            assert not torch.equal(_bits(p), _bits(p0)), i
