"""The port's training slice against the JAX package on the CPU: the four
losses (given the JAX package's own random draws), the position basis, the
train fold's batches, the synthetic data, the optimizers, non-finite
containment, checkpoints either package reads, resume, and the CLIs.

Weights cross with `nn.convert.params_from_jax`; data is made with numpy
from a seed, or written by the JAX package's fixture. Full-width modules
run at B <= 4. Tolerances are stated at each assert.
"""

import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.data import PoseDataset as JaxPoseDataset
from mobileposer_tpu.data import fixtures as jax_fixtures
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import modules as JM
from mobileposer_tpu.models import net as jax_net
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.cli import combine_weights as combine_cli
from mobileposer_tpu_torch.cli import finetune as finetune_cli
from mobileposer_tpu_torch.cli import overfit as overfit_cli
from mobileposer_tpu_torch.cli import process as process_cli
from mobileposer_tpu_torch.cli import train as train_cli
from mobileposer_tpu_torch.data import PoseDataset
from mobileposer_tpu_torch.data import fixtures
from mobileposer_tpu_torch.data.prefetch import BatchPrefetcher
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import modules as M
from mobileposer_tpu_torch.models.net import joint_positions_from_r6d_soa
from mobileposer_tpu_torch.models.modules import init_all_modules
from mobileposer_tpu_torch.nn.convert import (params_from_jax, params_to_jax,
                                              rnn_block_from_jax,
                                              rnn_block_to_jax)
from mobileposer_tpu_torch.parallel import make_mesh
from mobileposer_tpu_torch.train import trainer
from mobileposer_tpu_torch.utils.metrics import make_sinks

# the JAX package's fold_in indices: (noise, dropout) per module
_FOLDS = {"joints": (None, 0), "poser": (1, 2), "footcontact": (3, 4),
          "velocity": (5, 6)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the CPU path is thousands of small ops, which
    torch's thread pool slows down beside other busy test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


@pytest.fixture(scope="module")
def weights():
    """Random weights of the four modules as the JAX package's numpy
    pytree (`params_to_jax` of the port's seeded init), and the port's
    modules built back from it (`params_from_jax`)."""
    tree = params_to_jax(init_all_modules(torch.Generator().manual_seed(0),
                                          device="cpu"))
    return tree, params_from_jax(tree, device="cpu")


def _batch(rng, B, T, lengths, time_major=False):
    """A numpy training batch with explicit lengths."""
    f32 = np.float32
    b = {"imu": (rng.randn(B, T, 60) * 0.3).astype(f32),
         "joints": (rng.randn(B, T, 72) * 0.3).astype(f32),
         "pose_r6d": rng.randn(B, T, 24, 6).astype(f32),
         "vels": rng.randn(B, T, 72).astype(f32),
         "contacts": (rng.rand(B, T, 2) > 0.5).astype(f32),
         "lengths": np.asarray(lengths, np.int32)}
    if time_major:
        b = {k: (v if k == "lengths" else np.ascontiguousarray(
            np.swapaxes(v, 0, 1))) for k, v in b.items()}
    return b


def _jax_draws(name, batch, rng_key, train=True):
    """The JAX loss's own draws, as the port's `Draws`."""
    k_noise, k_drop = _FOLDS[name]
    cfg = M.MODULE_CONFIGS[name]
    noise = keep = None
    if k_noise is not None:
        noise = torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(rng_key, k_noise), batch["joints"].shape)))
    if train:
        keep = torch.tensor(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(rng_key, k_drop), 1.0 - cfg.dropout,
            batch["imu"].shape[:2] + (cfg.n_hidden,))))
    return M.Draws(noise, keep)


def _grad_tree(block):
    """The gradients of an RNNBlock in the JAX layout."""
    saved = [p.detach().clone() for p in block.parameters()]
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(p.grad)
    tree = rnn_block_to_jax(block)
    with torch.no_grad():
        for p, s in zip(block.parameters(), saved):
            p.copy_(s)
    return tree


@pytest.mark.parametrize("name,time_major", [
    ("joints", False), ("poser", False), ("footcontact", False),
    ("velocity", False), ("poser", True)])
def test_loss_and_gradients_match_jax(name, time_major, weights, bodies):
    """Each deterministic loss fed the JAX package's draws (noise and
    dropout masks) against the JAX loss (its XLA scan on the CPU), on a
    ragged batch of 2 x 24 frames: the loss at rtol 1e-5 and every
    parameter's gradient at 1e-5. Poser runs with the body (its FK
    position term)."""
    tree = weights[0]
    rng = np.random.RandomState(len(name) + time_major)
    batch = _batch(rng, 2, 24, [24, 17], time_major)
    key = jax.random.PRNGKey(7)
    jax_loss = {"joints": JM.joints_loss, "footcontact": JM.footcontact_loss,
                "velocity": JM.velocity_loss,
                "poser": lambda p, b, r, **kw: JM.poser_loss(
                    p, b, r, body_model=bodies[0], **kw)}[name]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jb, key, train=True, time_major=time_major)))(
        tree[name])

    block = rnn_block_from_jax(tree[name], M.MODULE_CONFIGS[name],
                               "cpu").requires_grad_(True)
    extra = {"body_model": bodies[1]} if name == "poser" else {}
    tb = trainer.to_device(batch, "cpu")
    got = M.LOSSES[name](block, tb, _jax_draws(name, batch, key),
                         train=True, time_major=time_major, **extra)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=1e-5),
        _grad_tree(block), want_g)


def test_validation_loss_matches_jax(weights, bodies):
    """train=False: the noise is still added, no dropout; the port's
    validation route (the inference kernels' plain versions, no grad)
    against the JAX loss at rtol 1e-5."""
    tree, modules = weights
    batch = _batch(np.random.RandomState(9), 2, 20, [20, 9])
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = trainer.to_device(batch, "cpu")
    for name in ("footcontact", "velocity"):
        want = jax.jit(lambda p: getattr(JM, f"{name}_loss")(
            p, jb, key, train=False))(tree[name])
        with torch.no_grad():
            got = M.LOSSES[name](modules[name], tb,
                                 _jax_draws(name, batch, key, train=False),
                                 train=False, backend="auto")
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=name)


def test_joint_positions_from_r6d_match_jax(bodies):
    """The position basis product against the JAX package at 1e-6."""
    r6d = np.random.RandomState(1).randn(50, 96).astype(np.float32)
    want = jax_net.joint_positions_from_r6d_soa(jnp.asarray(r6d), bodies[0])
    got = joint_positions_from_r6d_soa(torch.from_numpy(r6d), bodies[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def jax_written_file(tmp_path_factory, bodies):
    """Two 150-frame sequences written by the JAX package's fixture."""
    path = tmp_path_factory.mktemp("train_data") / "train.pt"
    jax_fixtures.make_synthetic_processed_dataset(
        path, n_sequences=2, T=150, seed=4, body_model=bodies[0])
    return path


def test_train_fold_matches_jax(jax_written_file, bodies):
    """The train fold read from one JAX-written file: windows of 125 (and
    a ragged 25), 12 combos. Fields copied from the file are equal; the
    FK-derived joints, pose_r6d and vels at 1e-5 (float32 FK). Given the
    same windows, `get`, `_assemble` and `batches` are bit-equal (numpy
    only)."""
    jds = JaxPoseDataset(fold="train", body_model=bodies[0],
                         data_files=[jax_written_file])
    ds = PoseDataset(fold="train", body_model=bodies[1],
                     data_files=[jax_written_file], device="cpu")
    assert len(ds) == len(jds) == 4 * 12
    for jw, w in zip(jds.windows, ds.windows):
        assert jw.keys() == w.keys()
        for k in w:
            if k in ("joints", "pose_r6d", "vels"):
                np.testing.assert_allclose(w[k], jw[k], atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(w[k], jw[k], err_msg=k)
    ds.windows = [dict(w) for w in jds.windows]
    for i in (0, 17, 47):
        for k, v in jds.get(i).items():
            np.testing.assert_array_equal(ds.get(i)[k], v, err_msg=k)
    idxs = np.array([3, 40, 11, 25, 47])
    got, want = ds._assemble(idxs, 125), jds._assemble(idxs, 125)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for gb, wb in zip(ds.batches(8, np.random.default_rng(5)),
                      jds.batches(8, np.random.default_rng(5))):
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_file_selection_matches_jax(tmp_path, monkeypatch, bodies):
    """Default files of the train fold, of finetune and of the test fold,
    as the JAX package picks them; an unknown fold raises."""
    monkeypatch.setenv("MP_PROCESSED", str(tmp_path))
    (tmp_path / "a.pt").write_bytes(b"")
    (tmp_path / "eval").mkdir()
    for kw in ({}, {"finetune": "dip"}, {"fold": "test",
                                         "evaluate": "totalcapture"}):
        kw = {"fold": "train", **kw}
        jds = JaxPoseDataset(body_model=bodies[0], data_files=[], **kw)
        ds = PoseDataset(body_model=bodies[1], data_files=[], device="cpu",
                         **kw)
        assert ds._default_files() == jds._default_files(), kw
    with pytest.raises(ValueError, match="fold"):
        PoseDataset(fold="valid", data_files=[], device="cpu")


def test_synthetic_sequence_matches_jax(bodies):
    """The port's fixture against the JAX package's on one 40-frame
    sequence from the same seed: pose, tran, joint, ori and contact at
    1e-5; acc, a second difference of vertex positions scaled by
    fps^2 = 900, at 1e-5 of its largest value."""
    want = jax_fixtures.synthetic_sequence(bodies[0],
                                           np.random.default_rng(3), 40)
    got = fixtures.synthetic_sequence(bodies[1], np.random.default_rng(3), 40)
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        atol = 1e-5 * float(np.abs(w).max()) if k == "acc" else 1e-5
        np.testing.assert_allclose(got[k], w, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["joints", "poser"])
def test_optimizer_matches_optax(name):
    """Identical gradients through optax (adamw(1e-3) for joints, with
    its default weight decay 1e-4; adam(1e-3) otherwise) and the port's
    `make_optimizer`, three steps, parameters at the modules' init scale
    U(-1/16, 1/16): parameters at 1e-7 (a few float32 ulps there; the two
    decay and divide in another order)."""
    rng = np.random.RandomState(0)
    p0 = {"w": rng.uniform(-0.0625, 0.0625, (5, 7)).astype(np.float32),
          "b": rng.uniform(-0.0625, 0.0625, 7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    opt = optax.adamw(1e-3) if name == "joints" else optax.adam(1e-3)
    params, state = jax.tree_util.tree_map(jnp.asarray, p0), None
    state = opt.init(params)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    topt = trainer.make_optimizer(name, 1e-3, module)
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state, params)
        params = optax.apply_updates(params, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in p0:
            np.testing.assert_allclose(module[k].detach().numpy(),
                                       np.asarray(params[k]), atol=1e-7)


def test_non_finite_batch_leaves_state_untouched(bodies):
    """A NaN batch through the concurrent step after one good step: every
    module's parameters and optimizer state stay bit-equal, and the step
    counts still advance."""
    step = trainer.make_multi_train_step(bodies[1])
    gen = torch.Generator().manual_seed(0)
    states = {n: trainer.init_train_state(n, gen, 1e-3, "cpu")
              for n in trainer.MODULE_NAMES}
    batch = _batch(np.random.RandomState(2), 2, 6, [6, 4])
    states, losses = step(states, trainer.to_device(batch, "cpu"), gen)
    assert all(np.isfinite(float(v)) for v in losses.values())
    before = {n: ([p.detach().clone() for p in s.params.parameters()],
                  {i: {k: v.clone() for k, v in st.items()}
                   for i, st in s.opt.state_dict()["state"].items()})
              for n, s in states.items()}
    batch["imu"][0, 0, 0] = np.nan
    states, losses = step(states, trainer.to_device(batch, "cpu"), gen)
    for n, s in states.items():
        assert not np.isfinite(float(losses[n]))
        assert s.step == 2
        for p, q in zip(s.params.parameters(), before[n][0]):
            assert torch.equal(p.detach(), q), n
        for i, st in s.opt.state_dict()["state"].items():
            for k, v in st.items():
                assert torch.equal(v, before[n][1][i][k]), (n, i, k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, bodies):
    """`train_all(fast_dev_run)` at batch 4 on the CPU: two steps over a
    port-written dataset of 2 x 60 frames, one validation batch."""
    root = tmp_path_factory.mktemp("train_all")
    fixtures.make_synthetic_processed_dataset(
        root / "data" / "t.pt", n_sequences=2, T=60, seed=1,
        body_model=bodies[1])
    ds = PoseDataset(fold="train", body_model=bodies[1],
                     data_files=[root / "data" / "t.pt"], device="cpu")
    hypers = dataclasses.replace(C.train_hypers, batch_size=4)
    mgr = trainer.TrainingManager(fast_dev_run=True, hypers=hypers,
                                  device="cpu")
    out = mgr.train_all(ds, root / "ckpt", body_model=bodies[1],
                        log_file=str(root / "ckpt" / "metrics.jsonl"))
    return root, ds, hypers, out


def test_train_all_checkpoints_load_in_jax_and_resume(trained, bodies):
    """Every module's best checkpoint is the trained weights, read back
    by the JAX package's `load_from_npz` exactly; `resume=True` restores
    each module's params and optimizer state from `train_state.pt`."""
    root, ds, hypers, out = trained
    records = [json.loads(ln) for ln in
               (root / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [r["module"] for r in records] == list(trainer.MODULE_NAMES)
    assert all(np.isfinite(r["train_loss"]) for r in records)
    for n in trainer.MODULE_NAMES:
        best = trainer.get_best_checkpoint(root / "ckpt" / n)
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               load_from_npz(str(best)),
                               rnn_block_to_jax(out["params"][n]))
    mgr = trainer.TrainingManager(fast_dev_run=True, hypers=hypers,
                                  device="cpu")
    resumed = mgr.train_all(ds, root / "ckpt", body_model=bodies[1],
                            resume=True)
    for n in trainer.MODULE_NAMES:
        for p, q in zip(resumed["params"][n].parameters(),
                        out["params"][n].parameters()):
            assert torch.equal(p, q)
        st, mod, nxt = trainer.restore_training_state(
            root / "ckpt" / n / trainer.STATE_FILE, hypers.lr, "cpu")
        assert (mod, nxt, st.step) == (n, 1, 2)
        assert len(st.opt.state_dict()["state"]) == len(
            list(st.params.parameters()))


def test_cli_train_and_combine_run_on_cpu(trained, tmp_path, monkeypatch):
    """`cli.train --module footcontact --fast-dev-run` (train_module) and
    `cli.combine_weights` run; the combined file loads in the JAX
    package, and `--export-torch` writes its reference-format .pth;
    `--finetune dip` with a TensorBoard sink, `cli.finetune`,
    `cli.overfit` and `cli.process` run; the multi-device options raise
    naming their ROADMAP row; the wandb sink raises ImportError while
    wandb is not installed."""
    root = trained[0]
    monkeypatch.setenv("MP_PROCESSED", str(root / "data"))
    ckpt = tmp_path / "ckpt"
    train_cli.main(["--module", "footcontact", "--fast-dev-run",
                    "--checkpoint-dir", str(ckpt), "--device", "cpu",
                    "--metrics", f"csv:{tmp_path / 'm.csv'}"])
    assert trainer.get_best_checkpoint(ckpt / "footcontact") is not None
    assert (tmp_path / "m.csv").read_text().startswith("module,epoch")
    out = combine_cli.main(["--checkpoint-dir", str(root / "ckpt"),
                            "--out", str(tmp_path / "combined.npz")])
    assert set(load_from_npz(str(out))) == set(trainer.MODULE_NAMES)
    # --finetune reads $MP_PROCESSED/eval/dip_train.pt, with the finetune
    # hyperparameters; the TensorBoard sink writes its event file
    proc = tmp_path / "proc"
    (proc / "eval").mkdir(parents=True)
    (proc / "eval" / "dip_train.pt").write_bytes(
        (root / "data" / "t.pt").read_bytes())
    monkeypatch.setenv("MP_PROCESSED", str(proc))
    train_cli.main(["--fast-dev-run", "--device", "cpu", "--module",
                    "joints", "--checkpoint-dir", str(tmp_path / "ft"),
                    "--finetune", "dip", "--metrics",
                    f"tensorboard:{tmp_path / 'tb'}"])
    assert trainer.get_best_checkpoint(tmp_path / "ft" / "joints")
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    # --export-torch writes the reference-format .pth of the combined
    # weights (tests/test_torch_torch_convert.py holds it to the JAX CLI)
    combine_cli.main(["--checkpoint-dir", str(root / "ckpt"), "--out",
                      str(tmp_path / "combined2.npz"), "--export-torch",
                      str(tmp_path / "x.pth")])
    sd = torch.load(tmp_path / "x.pth", weights_only=True)
    np.testing.assert_array_equal(
        sd["pose.pose.linear1.weight"].numpy(),
        load_from_npz(str(out))["poser"]["linear1"]["w"].T)
    # data-parallel training is ported (tests/test_torch_parallel_train.py
    # runs it in two processes): a one-entry mesh trains on its device, a
    # larger mesh needs a process group of as many ranks, and an unknown
    # rule is refused
    mgr = trainer.TrainingManager(mesh=make_mesh(devices=["cpu"]),
                                  dp_impl="shard_map")
    assert mgr.device == torch.device("cpu") and mgr.world == 1
    with pytest.raises(RuntimeError, match="process group"):
        trainer.TrainingManager(mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="dp_impl"):
        trainer.TrainingManager(device="cpu", dp_impl="pmap")
    # bf16 residuals are ported: the manager takes them, an unknown
    # backend is refused
    mgr = trainer.TrainingManager(device="cpu", backend="auto_train_bf16res")
    assert mgr.backend == "auto_train_bf16res"
    with pytest.raises(NotImplementedError, match="not ported"):
        trainer.TrainingManager(device="cpu", backend="xla")
    with pytest.raises(ImportError):
        make_sinks("wandb:proj")
    # the finetune, overfit and process CLIs run (held to the JAX CLIs in
    # tests/test_torch_recipes.py and tests/test_torch_process.py)
    base = tmp_path / "base"
    import shutil
    shutil.copytree(root / "ckpt", base)
    out = finetune_cli.main(["--dataset", "dip", "--checkpoint-dir",
                             str(base), "--fast-dev-run", "--concurrent",
                             "--device", "cpu"])
    for n in ("joints", "poser"):
        assert trainer.get_best_checkpoint(out / n) is not None
    losses = overfit_cli.main(["--module", "footcontact", "--steps", "2",
                               "--synthetic", "--batch-size", "2",
                               "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    process_cli.main(["--dataset", "synthetic", "--device", "cpu"])
    assert len(PoseDataset(data_files=[proc / "synthetic.pt"],
                           device="cpu").windows) == 8 * 4


def test_prefetcher_delivers_in_order_and_surfaces_errors():
    def gen(n, fail=False):
        for i in range(n):
            yield i
        if fail:
            raise KeyError("boom")

    with BatchPrefetcher(gen(5)) as pf:
        assert list(pf) == [0, 1, 2, 3, 4]
    with pytest.raises(KeyError, match="boom"):
        list(BatchPrefetcher(gen(2, fail=True)))
    pf = BatchPrefetcher(gen(100), depth=1)
    assert next(pf) == 0
    pf.close()                                  # abandoned early: no hang
    assert not pf._thread.is_alive()
