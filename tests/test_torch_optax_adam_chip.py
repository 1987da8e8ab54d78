"""On the card: `OptaxAdam`'s fused step (`ops/csrc/optax_adam.cu`, one
launch a module step) against the per-tensor chain of torch ops
(`ops.optax_adam_cuda.optax_adam_plain`) on the same CUDA tensors, and
against the CPU `OptaxAdam`, bit for bit over three steps of each of the
four modules at their shapes; the refusals of float32 and non-contiguous
tensors; and a `state_dict` round trip.

Tests marked `chip` skip without a card. Run them on a machine with one,
where JAX is not installed and the tests' conftest cannot load:
`python -m pytest tests/test_torch_optax_adam_chip.py -q -m chip
--noconftest -p no:cacheprovider`.
"""

import copy
import io

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.ops import optax_adam_cuda
from mobileposer_tpu_torch.train import trainer

BF16 = torch.bfloat16
LR = 1e-3
STEPS = 3

pytestmark = pytest.mark.chip


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _grads(rng, params):
    return [torch.from_numpy((rng.randn(*p.shape) * 10.0 ** rng.uniform(
        -4, 0, p.shape)).astype(np.float32)).to(BF16) for p in params]


def _bits(t):
    return t.detach().cpu().view(torch.int16)


@pytest.mark.parametrize("name", trainer.MODULE_NAMES)
def test_fused_step_equals_the_chain_on_the_card(cuda_device, name):
    state = trainer.init_train_state(name, torch.Generator().manual_seed(3),
                                     LR, cuda_device, BF16)
    cpu = trainer.init_train_state(name, torch.Generator().manual_seed(3),
                                   LR, "cpu", BF16)
    assert isinstance(state.opt, trainer.OptaxAdam)
    params = list(state.params.parameters())
    cpu_params = list(cpu.params.parameters())
    chain = [p.detach().clone() for p in params]
    mus = [torch.zeros_like(p) for p in chain]
    nus = [torch.zeros_like(p) for p in chain]
    group = state.opt.param_groups[0]
    rng = np.random.RandomState(17)
    optax_adam_cuda.reset_launches()
    for k in range(1, STEPS + 1):
        grads = _grads(rng, params)
        for p, q, g in zip(params, cpu_params, grads):
            p.grad = g.to(cuda_device)
            q.grad = g
        state.opt.step()
        assert optax_adam_cuda.launches["optax_adam_bf16"] == k
        consts = optax_adam_cuda.constants(
            *group["betas"], group["eps"], group["weight_decay"], LR, k, BF16)
        optax_adam_cuda.optax_adam_plain(
            chain, [p.grad for p in params], mus, nus, consts,
            bool(group["weight_decay"]))
        cpu.opt.step()
        torch.cuda.synchronize(cuda_device)
        for i, p in enumerate(params):
            st = state.opt.state[p]
            assert torch.equal(_bits(p), _bits(chain[i])), (k, i)
            assert torch.equal(_bits(st["mu"]), _bits(mus[i])), (k, i)
            assert torch.equal(_bits(st["nu"]), _bits(nus[i])), (k, i)
            assert torch.equal(_bits(p), _bits(cpu_params[i])), (k, i)


def test_refusals_on_the_card(cuda_device):
    # float32 params on the card: the kernel takes bf16 only
    p32 = torch.nn.Parameter(torch.zeros(8, 4, device=cuda_device))
    opt = trainer.OptaxAdam([p32], lr=LR)
    p32.grad = torch.ones_like(p32)
    with pytest.raises(ValueError, match="bfloat16"):
        opt.step()
    # a non-contiguous gradient
    p = torch.nn.Parameter(torch.zeros(8, 4, dtype=BF16, device=cuda_device))
    opt = trainer.OptaxAdam([p], lr=LR)
    p.grad = torch.ones(4, 8, dtype=BF16, device=cuda_device).t()
    with pytest.raises(ValueError, match="contiguous"):
        opt.step()
    t = torch.zeros(8, 4, dtype=BF16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        optax_adam_cuda.optax_adam(
            [t.t()], [t.t()], [t.t()], [t.t()],
            optax_adam_cuda.constants(0.9, 0.999, 1e-8, 0.0, LR, 1, BF16),
            False)


def test_state_dict_round_trip_on_the_card(cuda_device):
    state = trainer.init_train_state("joints", torch.Generator().manual_seed(
        5), LR, cuda_device, BF16)
    rng = np.random.RandomState(23)
    params = list(state.params.parameters())
    for p, g in zip(params, _grads(rng, params)):
        p.grad = g.to(cuda_device)
    state.opt.step()
    buf = io.BytesIO()
    torch.save(state.opt.state_dict(), buf)
    buf.seek(0)
    resumed_params = copy.deepcopy(state.params)
    resumed = trainer.make_optimizer("joints", LR, resumed_params)
    resumed.load_state_dict(torch.load(buf, weights_only=True))
    rparams = list(resumed_params.parameters())
    for _ in range(2):
        grads = _grads(rng, params)
        for p, q, g in zip(params, rparams, grads):
            p.grad = g.to(cuda_device)
            q.grad = g.to(cuda_device)
        state.opt.step()
        resumed.step()
    for p, q in zip(params, rparams):
        assert torch.equal(_bits(p), _bits(q))
        for m in ("mu", "nu"):
            assert torch.equal(_bits(state.opt.state[p][m]),
                               _bits(resumed.state[q][m]))
        assert resumed.state[q]["step"] == 3
