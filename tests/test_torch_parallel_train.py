"""The port's data-parallel training (`train.trainer` over
`parallel.distributed`) rehearsed on the CPU: two processes of this file
join one gloo process group the way torchrun starts them (MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE), and run

  * one concurrent train step under each rule on a ragged batch: 'gspmd'
    must equal the one-process step on the whole batch (loss rtol 1e-5,
    gradients within 1e-5 of their largest magnitude), 'shard_map' must
    report the mean of the ranks' own losses, whose draws differ;
  * the same step under each rule on bf16 params (`OptaxAdam` on the
    gradients rounded back to bf16 after the float32 sum), held to jitted
    optax on the reduced gradients and ('gspmd') to the one-process bf16
    step on the whole batch;
  * `make_shard_map_train_step` on one module;
  * `TrainingManager(mesh=...)` `fast_dev_run`, `train_all` and
    `train_module`, where only rank 0 writes, and `train_all(resume=True)`
    from rank 0's files alone;
  * `cli.train` on the group.

In this process: each rank's loss and gradients against the JAX package's
`loss_fn_for` on the same shard, and the 'gspmd' parts against the JAX
loss of the whole batch. Full-width modules at B = 4, T = 24; torch on one
thread.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import modules as M
from mobileposer_tpu_torch.parallel import distributed as D
from mobileposer_tpu_torch.parallel import make_mesh
from mobileposer_tpu_torch.train import trainer

HERE = Path(__file__).resolve()
ROOT = HERE.parents[1]
WORLD = 2
LENGTHS = [24, 17, 24, 9]
T = 24
STEP_SEED = 3
LR = 1e-3
# bf16 gradients of the data-parallel step against one process's, in bf16
# ulps of each tensor's largest magnitude (test_bf16_step_over_the_group)
DP_GRAD_ULPS = 4


def _batch(rng, lengths=LENGTHS):
    B = len(lengths)
    f32 = np.float32
    return {"imu": (rng.randn(B, T, 60) * 0.3).astype(f32),
            "joints": (rng.randn(B, T, 72) * 0.3).astype(f32),
            "pose_r6d": rng.randn(B, T, 24, 6).astype(f32),
            "vels": rng.randn(B, T, 72).astype(f32),
            "contacts": (rng.rand(B, T, 2) > 0.5).astype(f32),
            "lengths": np.asarray(lengths, np.int32)}


def _states(dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    return {n: trainer.init_train_state(n, gen, LR, "cpu", dtype)
            for n in trainer.MODULE_NAMES}


def _grads(states):
    """Every gradient, flat, in float32 (a bf16 one widened exactly)."""
    return np.concatenate([p.grad.float().reshape(-1).numpy()
                           for n in trainer.MODULE_NAMES
                           for p in states[n].params.parameters()])


def _params(states):
    return np.concatenate([p.detach().float().reshape(-1).numpy()
                           for n in trainer.MODULE_NAMES
                           for p in states[n].params.parameters()])


def _body():
    return ParametricModel.synthetic(num_vertices=240)


def _sums(state):
    """The sums of a train state's params and optimizer moments."""
    moments = [float(t.double().sum()) for st in state.opt.state.values()
               for t in st.values() if torch.is_tensor(t)]
    return [float(p.detach().double().sum())
            for p in state.params.parameters()] + \
        moments


def _worker(rank: int, out: Path) -> None:
    """One rank: joins the group from the environment, as under torchrun."""
    torch.set_num_threads(1)
    assert D.join_or_spawn(None, [], "cpu") is None
    assert D.rank() == rank and D.world_size() == WORLD
    mesh = make_mesh(devices=["cpu"] * WORLD)
    body = _body()
    batch = _batch(np.random.RandomState(STEP_SEED))
    local = trainer.to_device(trainer.local_rows(batch, rank, WORLD), "cpu")
    res = {}
    for impl in ("gspmd", "shard_map"):
        states = _states()
        step = trainer.make_multi_train_step(body, mesh=mesh, dp_impl=impl)
        states, losses = step(states, local,
                              torch.Generator().manual_seed(STEP_SEED))
        res[impl] = {n: float(v) for n, v in losses.items()}
        np.save(out / f"grads_{impl}_{rank}.npy", _grads(states))
        # the same step on bf16 params (`OptaxAdam`)
        states = _states(torch.bfloat16)
        states, losses = step(states, local,
                              torch.Generator().manual_seed(STEP_SEED))
        res[f"bf16_{impl}"] = {n: float(v) for n, v in losses.items()}
        res[f"bf16_{impl}_dtypes"] = sorted(
            {str(t.dtype) for s in states.values()
             for p in s.params.parameters() for t in (p, p.grad)})
        np.save(out / f"grads_bf16_{impl}_{rank}.npy", _grads(states))
        np.save(out / f"params_bf16_{impl}_{rank}.npy", _params(states))
    # this rank's own shard_map losses, on rows all equal to row 0: only
    # the folded draws differ between the ranks
    same = {k: np.repeat(v[:1], len(LENGTHS), axis=0)
            for k, v in batch.items()}
    fns = {n: trainer.loss_fn_for(n, body) for n in trainer.MODULE_NAMES}
    params = {n: s.params for n, s in _states().items()}
    for key, b in (("own", batch), ("own_same_rows", same)):
        with torch.no_grad():
            own = trainer._rank_losses(
                fns, params, trainer.to_device(
                    trainer.local_rows(b, rank, WORLD), "cpu"),
                torch.Generator().manual_seed(STEP_SEED), (rank, WORLD),
                "shard_map", True)
        res[key] = {n: float(v) for n, v in own.items()}
    # one module's shard_map step, and its own loss on this rank's rows
    gen = torch.Generator().manual_seed(STEP_SEED)
    _, loss = trainer.make_shard_map_train_step("footcontact", mesh)(
        _states()["footcontact"], local, gen)
    with torch.no_grad():
        own = trainer._rank_losses(
            {"footcontact": fns["footcontact"]},
            {"footcontact": params["footcontact"]}, local,
            torch.Generator().manual_seed(STEP_SEED), (rank, WORLD),
            "shard_map", True)
    res["one_module"] = [float(loss), float(own["footcontact"])]
    # the manager and the CLI on the group: only rank 0 writes
    from mobileposer_tpu_torch.cli import train as train_cli
    from mobileposer_tpu_torch.data import PoseDataset
    ds = PoseDataset(fold="train", body_model=body,
                     data_files=[out / "data" / "t.pt"], device="cpu")
    mgr = trainer.TrainingManager(
        fast_dev_run=True, mesh=mesh,
        hypers=dataclasses.replace(C.train_hypers, batch_size=4))
    assert (mgr.rank, mgr.world, mgr.writer) == (rank, WORLD, rank == 0)
    hist = mgr.train_all(ds, out / f"manager{rank}", body_model=body)
    res["manager"] = {n: h["train_loss"] + h["val_loss"]
                      for n, h in hist["history"].items()}
    one = mgr.train_module("footcontact", ds, out / f"module{rank}")
    res["manager_module"] = one["history"]["train_loss"]
    # resume from rank 0's files alone: rank 1's run dir is empty, as on a
    # host that does not share rank 0's file system
    again = trainer.TrainingManager(
        fast_dev_run=True, mesh=mesh,
        hypers=dataclasses.replace(C.train_hypers, batch_size=4))
    state, _, nxt = again._restore(out / f"manager{rank}" / "poser"
                                   / trainer.STATE_FILE)
    res["restored"] = [nxt, state.step, _sums(state)]
    resumed = again.train_all(ds, out / f"manager{rank}", body_model=body,
                              resume=True)
    res["resumed"] = {n: [float(p.detach().double().sum())
                          for p in m.parameters()]
                      for n, m in resumed["params"].items()}
    os.environ["MP_PROCESSED"] = str(out / "data")
    train_cli.main(["--fast-dev-run", "--concurrent", "--device", "cpu",
                    "--checkpoint-dir", str(out / f"cli{rank}")])
    (out / f"rank{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two ranks once; their results, and the output dir."""
    from mobileposer_tpu_torch.data import fixtures
    out = tmp_path_factory.mktemp("ranks")
    (out / "data").mkdir()
    fixtures.make_synthetic_processed_dataset(
        out / "data" / "t.pt", n_sequences=2, T=60, seed=1,
        body_model=_body())
    for attempt in range(3):
        port = D._free_port()
        procs, logs = [], []
        for r in range(WORLD):
            env = dict(os.environ, PYTHONPATH=str(ROOT),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(r), WORLD_SIZE=str(WORLD))
            log = open(out / f"worker{r}.{attempt}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE), str(r), str(out)], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))
        try:
            rcs = [p.wait(timeout=240) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        # the probe socket closes before the store binds the port: another
        # process can take it in between, and then only that is retried
        if rcs == [0] * WORLD or not any("address already in use"
                                         in t.lower() for t in texts):
            break
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"rank {r} rc={rc}\n{text[-4000:]}"
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)], out


def test_gspmd_step_equals_one_process_on_the_whole_batch(ranks):
    res, out = ranks
    states = _states()
    step = trainer.make_multi_train_step(_body())
    batch = trainer.to_device(_batch(np.random.RandomState(STEP_SEED)),
                              "cpu")
    states, want = step(states, batch,
                        torch.Generator().manual_seed(STEP_SEED))
    want_g = _grads(states)
    for r in range(WORLD):
        for n in trainer.MODULE_NAMES:
            np.testing.assert_allclose(res[r]["gspmd"][n], float(want[n]),
                                       rtol=1e-5, err_msg=n)
        got_g = np.load(out / f"grads_gspmd_{r}.npy")
        assert np.abs(got_g - want_g).max() <= 1e-5 * np.abs(want_g).max()


def test_shard_map_step_is_the_mean_of_rank_losses_and_draws_differ(ranks):
    res, out = ranks
    for n in trainer.MODULE_NAMES:
        mean = np.mean([res[r]["own"][n] for r in range(WORLD)])
        for r in range(WORLD):
            np.testing.assert_allclose(res[r]["shard_map"][n], mean,
                                       rtol=1e-6, err_msg=n)
    # every rank reduced the same gradients
    np.testing.assert_array_equal(np.load(out / "grads_shard_map_0.npy"),
                                  np.load(out / "grads_shard_map_1.npy"))
    # equal rows, equal params: only the folded draws tell ranks apart
    for n in ("poser", "footcontact", "velocity", "joints"):
        assert res[0]["own_same_rows"][n] != res[1]["own_same_rows"][n], n
    # make_shard_map_train_step: one module, the same rule
    mean = np.mean([res[r]["one_module"][1] for r in range(WORLD)])
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["one_module"][0], mean, rtol=1e-6)


def _optax_step(states):
    """One jitted optax step (adamw(LR) for joints, adam(LR) for the
    rest, as `make_optimizer` sets them) of each module's bf16 params from
    their initial values, on the gradients `states` hold; flat, float32."""
    import jax
    import jax.numpy as jnp
    import optax
    out = []
    for n in trainer.MODULE_NAMES:
        ps = list(states[n].params.parameters())
        params = [jnp.asarray(p.detach().float().numpy()).astype(
            jnp.bfloat16) for p in ps]
        grads = [jnp.asarray(p.grad.float().numpy()).astype(jnp.bfloat16)
                 for p in ps]
        opt = optax.adamw(LR) if n == "joints" else optax.adam(LR)

        @jax.jit
        def step(params, grads):
            updates, _ = opt.update(grads, opt.init(params), params)
            return optax.apply_updates(params, updates)

        out += [np.asarray(q).astype(np.float32).reshape(-1)
                for q in step(params, grads)]
    return np.concatenate(out)


def _ulps_of_own(got, want):
    """Each difference in bf16 ulps of the entry's own magnitude (the rule
    of tests/test_torch_train_bf16.py's optimizer test)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
def test_bf16_step_over_the_group(ranks, impl):
    """bf16 params over the group: `all_reduce_step` sums the ranks'
    gradients in one float32 buffer and hands each back rounded to bf16,
    which `OptaxAdam` steps. Every param and gradient bf16 and both ranks
    equal bit for bit; the updated params within 1 bf16 ulp of their own
    magnitude of jitted optax's step on the same reduced gradients (0
    measured). 'gspmd' also against the one-process bf16 step on the whole
    batch: losses rtol 1e-5; each gradient tensor within DP_GRAD_ULPS bf16
    ulps of its largest magnitude (2 measured: each rank's part is rounded
    to bf16 before the sum, the one process's whole sum once); and each
    updated param within 1 bf16 ulp of the larger of the two plus an
    allowance for the step: lr * 2**-5 where the one-process gradient
    exceeds twice the gradients' bound (a step from zero moments moves a
    param by lr times g / |g| up to rounding, whatever g's size), else
    2 lr (1 + 2**-5), where a gradient near zero may take the other sign."""
    res, out = ranks
    grads = [np.load(out / f"grads_bf16_{impl}_{r}.npy")
             for r in range(WORLD)]
    params = [np.load(out / f"params_bf16_{impl}_{r}.npy")
              for r in range(WORLD)]
    for r in range(WORLD):
        assert res[r][f"bf16_{impl}_dtypes"] == ["torch.bfloat16"]
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_array_equal(params[0], params[1])
    states = _states(torch.bfloat16)
    offset = 0
    for n in trainer.MODULE_NAMES:
        for p in states[n].params.parameters():
            p.grad = torch.from_numpy(grads[0][offset:offset + p.numel()]
                                      .reshape(p.shape)).to(torch.bfloat16)
            offset += p.numel()
    assert _ulps_of_own(params[0], _optax_step(states)).max() <= 1
    if impl != "gspmd":
        return
    one = _states(torch.bfloat16)
    step = trainer.make_multi_train_step(_body())
    batch = trainer.to_device(_batch(np.random.RandomState(STEP_SEED)),
                              "cpu")
    one, losses = step(one, batch, torch.Generator().manual_seed(STEP_SEED))
    for n in trainer.MODULE_NAMES:
        np.testing.assert_allclose(res[0]["bf16_gspmd"][n], float(losses[n]),
                                   rtol=1e-5, err_msg=n)
    want_g, want_p = _grads(one), _params(one)
    offset = 0
    for n in trainer.MODULE_NAMES:
        for i, p in enumerate(one[n].params.parameters()):
            part = slice(offset, offset + p.numel())
            offset += p.numel()
            g, wg = grads[0][part], want_g[part]
            ulp_g = 2.0 ** (np.floor(np.log2(np.abs(wg).max())) - 7)
            assert np.abs(g - wg).max() <= DP_GRAD_ULPS * ulp_g, (n, i)
            got, want = params[0][part], want_p[part]
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(
                np.abs(got), np.abs(want)), 2.0 ** -126))) - 7)
            allow = ulp + np.where(np.abs(wg) > 2 * DP_GRAD_ULPS * ulp_g,
                                   LR * 2 ** -5, 2 * LR * (1 + 2 ** -5))
            assert (np.abs(got - want) <= allow).all(), (n, i)


def test_manager_and_cli_over_the_group_write_on_rank_0_only(ranks):
    res, out = ranks
    assert res[0]["manager"] == res[1]["manager"]
    assert res[0]["manager_module"] == res[1]["manager_module"]
    assert trainer.get_best_checkpoint(out / "module0" / "footcontact")
    assert not [p for p in (out / "module1").rglob("*") if p.is_file()]
    for n, losses in res[0]["manager"].items():
        assert np.all(np.isfinite(losses)), n
    for kind in ("manager", "cli"):
        for n in trainer.MODULE_NAMES:
            assert trainer.get_best_checkpoint(out / f"{kind}0" / n), n
            assert (out / f"{kind}0" / n / trainer.STATE_FILE).exists()
        assert not [p for p in (out / f"{kind}1").rglob("*") if p.is_file()]
    records = (out / "cli0" / "metrics.jsonl").read_text().splitlines()
    assert len(records) == len(trainer.MODULE_NAMES)


def test_resume_follows_rank_0s_files_on_every_rank(ranks):
    """Rank 1 sees no train state; it resumes from rank 0's all the same,
    params and Adam moments included, and both ranks skip the epoch that
    rank 0's files hold (no collective left unmatched)."""
    res, out = ranks
    want = trainer.restore_training_state(
        out / "manager0" / "poser" / trainer.STATE_FILE, 1e-3, "cpu")
    assert not (out / "manager1" / "poser" / trainer.STATE_FILE).exists()
    for r in range(WORLD):
        assert res[r]["restored"] == [want[2], want[0].step, _sums(want[0])]
    assert len(res[0]["restored"][2]) > sum(
        1 for _ in want[0].params.parameters())
    assert res[0]["resumed"] == res[1]["resumed"]


def _jax():
    import jax
    import jax.numpy as jnp
    from mobileposer_tpu.kinematics import ParametricModel as JaxBody
    from mobileposer_tpu.train.trainer import loss_fn_for
    return jax, jnp, JaxBody, loss_fn_for


def _jax_draws(jax, name, batch, key, train):
    """The draws of the JAX package's loss (its fold_in indices)."""
    k_noise, k_drop = {"joints": (None, 0), "poser": (1, 2),
                       "footcontact": (3, 4), "velocity": (5, 6)}[name]
    cfg = M.MODULE_CONFIGS[name]
    noise = keep = None
    if k_noise is not None:
        noise = torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(key, k_noise), batch["joints"].shape)))
    if train:
        keep = torch.tensor(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, k_drop), 1.0 - cfg.dropout,
            batch["imu"].shape[:2] + (cfg.n_hidden,))))
    return M.Draws(noise, keep)


@pytest.mark.parametrize("name", ["poser", "velocity"])
def test_rank_losses_match_jax_per_shard_and_gspmd_parts_sum_to_jax(name):
    """train=False: each shard's loss and gradients against the JAX
    `loss_fn_for` on that shard, its key folded with the shard index as
    the JAX shard_map step folds it (rtol 1e-5, gradients 1e-5, the pins
    of tests/test_torch_train.py); then the 'gspmd' parts, fed the JAX
    draws of the whole batch, summed against the JAX loss of the whole
    batch at the same pins."""
    jax, jnp, JaxBody, jax_loss_fn_for = _jax()
    from mobileposer_tpu_torch.nn.convert import (params_to_jax,
                                                  rnn_block_from_jax,
                                                  rnn_block_to_jax)
    tree = params_to_jax(M.init_all_modules(torch.Generator().manual_seed(0),
                                            device="cpu"))[name]
    cfg = M.MODULE_CONFIGS[name]
    jbody, body = JaxBody.synthetic(num_vertices=240), _body()
    extra = {"body_model": body} if name == "poser" else {}
    jfn = jax_loss_fn_for(name, jbody if name == "poser" else None,
                          backend="xla")
    batch = _batch(np.random.RandomState(11))
    key = jax.random.PRNGKey(7)

    def port(b, draws, **kw):
        block = rnn_block_from_jax(tree, cfg, "cpu").requires_grad_(True)
        loss = M.LOSSES[name](block, trainer.to_device(b, "cpu"), draws,
                              train=False, backend="auto_train", **extra,
                              **kw)
        loss.backward()
        with torch.no_grad():                # the gradients, in JAX layout
            for p in block.parameters():
                p.copy_(p.grad)
        return float(loss.detach()), rnn_block_to_jax(block)

    def check(got, want):
        np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-5)
        jax.tree_util.tree_map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), atol=1e-5), got[1], want[1])

    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b, k: jfn(p, b, k, train=False)))
    parts = []
    whole = _jax_draws(jax, name, batch, key, False)
    for s in range(WORLD):
        shard = D.host_local_batch(batch, s, WORLD)
        k_s = jax.random.fold_in(key, s)
        want = value_and_grad(tree, {k: jnp.asarray(v)
                                     for k, v in shard.items()}, k_s)
        check(port(shard, _jax_draws(jax, name, shard, k_s, False)), want)
        rows = slice(s * 2, s * 2 + 2)
        parts.append(port(shard, M.Draws(whole.noise[rows], None),
                          count_lengths=torch.as_tensor(
                              batch["lengths"]).long()))
    want = value_and_grad(tree, {k: jnp.asarray(v) for k, v in batch.items()},
                          key)
    total = (sum(p[0] for p in parts),
             jax.tree_util.tree_map(lambda a, b: a + b, parts[0][1],
                                    parts[1][1]))
    check(total, want)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), Path(sys.argv[2]))
