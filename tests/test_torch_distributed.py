"""The multi-rank paths of ``repro_torch`` on gloo process groups of CPU
ranks, spawned from the test (``tests/test_torch_distributed_worker.py``,
one thread a rank, a ``FileStore`` under the test's ``tmp_path``), held
against the one-process port and the JAX reference.

(a) Dense training: smollm-135m reduced, fp32, on a 2 x 4 (data, model)
    mesh. The first step's loss and every gradient are within 1e-5 of
    each leaf's max of the one-process step; 12 sharded train steps
    lower the loss; a sharded decode step's logits are within 1e-4 of
    max |logit| of the one-process step's.
(b) Expert parallelism: deepseek-v2-236b reduced on 2 x 4.
    ``moe_forward_ep``'s output, exact and with the capacity drops, is
    within 1e-5 of max |y| of the reference's ``moe_forward_ep`` on 8
    host devices on the same inputs; the ``_ep_shard`` partials of the
    four ranks sum (plus the shared experts) to ``moe_forward(exact=
    True)`` within 1e-5; with a capacity that drops no pair, the first
    sharded step's loss and every gradient are within 1e-5 of each
    leaf's max of the one-process step; a 12-step sharded MoE train
    keeps a finite loss that ends below 1.05 x its first (the reference
    test's bar).
(c) Scenario split: the reference test's 2 workloads x 4 regions grid on
    2 ranks equals the one-rank run bit for bit (encodings, frontier
    vectors, best costs, histories) and the reference's run split over 2
    host devices within 1e-6.
(d) Sharded resume: the split grid interrupted at a segment boundary
    and resumed equals the uninterrupted split run bit for bit.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_support import REPO, SRC, run_reference

WORKER = os.path.join(REPO, "tests", "test_torch_distributed_worker.py")

SCENARIO_REGIONS = {"hydro": 0.024, "eu-avg": 0.276,
                    "world-avg": 0.475, "coal-heavy": 0.82}
RESUME_REGIONS = {"hydro": 0.024, "coal-heavy": 0.82}


def spawn(case: str, world: int, tmp_path, *extra: str,
          timeout: float = 240.0):
    """Run ``case`` on ``world`` gloo ranks; rank 0's results."""
    store = str(tmp_path / f"store_{case}")
    out = str(tmp_path / f"out_{case}.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), store, out,
         *extra], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(rc, e) for rc, e in errs if rc != 0]
    assert not bad, bad[0][1][-4000:]
    return dict(np.load(out, allow_pickle=False))


def scenario_run(shard, variant="grid", resume_dir=None, interrupt=False):
    """The reference test's grid (2 workloads x 4 regions, 2 directions,
    2 chains, 2 sweeps, 80 normalizer samples, key 5), or its ``resume``
    variant (2 regions, 4 sweeps in segments of 2, key 6, checkpoints
    under ``resume_dir`` when given, the first save raising
    ``KeyboardInterrupt`` when ``interrupt``)."""
    from repro_torch.core.workload import workload
    from repro_torch.pathfinding import ScalarizationSweep, ScenarioSweep

    wls = [workload(1), workload(6)]
    if variant == "grid":
        sweep = ScenarioSweep(
            strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=2),
            regions=SCENARIO_REGIONS, norm_samples=80, shard=shard)
        return sweep.run(wls, key=5, torch_device="cpu")
    sweep = ScenarioSweep(
        strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=4),
        regions=RESUME_REGIONS, norm_samples=80, shard=shard)
    if not interrupt:
        return sweep.run(wls, key=6, segment=2, checkpoint_dir=resume_dir,
                         torch_device="cpu")
    import repro_torch.pathfinding.strategies as strategies_mod
    from repro_torch.pathfinding.resume import SearchCheckpointer

    class Dying(SearchCheckpointer):
        saves = 0

        def save(self, *a, **k):
            path = super().save(*a, **k)
            Dying.saves += 1
            if Dying.saves == 1:
                raise KeyboardInterrupt("simulated preemption")
            return path

    orig = strategies_mod._checkpointer
    strategies_mod._checkpointer = (
        lambda cd: Dying(cd) if cd is not None else None)
    try:
        return sweep.run(wls, key=6, segment=2, checkpoint_dir=resume_dir,
                         torch_device="cpu")
    finally:
        strategies_mod._checkpointer = orig


def _close(got, want, rel, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


# ---------------------------------------------------------------------------
# (a) dense training and decode on 2 x 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return spawn("dense", 8, tmp_path_factory.mktemp("dense"))


def _one_process_step(cfg):
    """The first step's loss and gradients in one process."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model, loss_fn
    from test_torch_distributed_worker import BATCH, SEQ

    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cpu",
                       trainable=True)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH, seed=0),
                                  torch_device="cpu")
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss = loss_fn(model, pipe.batch(0), remat=True)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return float(loss.detach()), {
        n: (torch.zeros_like(p) if g is None else g).detach().numpy()
        for (n, p), g in zip(params.items(), grads)}


def _first_step_matches(run, cfg):
    loss, grads = _one_process_step(cfg)
    _close(run["loss0"], loss, 1e-5, "loss")
    names = {k[5:] for k in run if k.startswith("grad/")}
    assert names == set(grads)
    for name, g in grads.items():
        _close(run["grad/" + name], g, 1e-5, name)


def test_dense_first_step_matches_one_process(dense):
    from repro_torch.configs import get_config

    _first_step_matches(dense, get_config("smollm-135m").reduced())


def test_dense_sharded_training_lowers_the_loss(dense):
    losses = dense["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_dense_sharded_decode_matches_one_process(dense):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_step
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_cache, init_model
    from test_torch_distributed_worker import DECODE

    cfg = get_config("smollm-135m").reduced()
    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cpu")
    b = DECODE["batch"]
    cache = init_cache(cfg, b, DECODE["cache"], DTypePolicy(),
                       torch_device="cpu")
    nxt, logits, _, _ = serve_step(
        model, cache, torch.zeros((b,), dtype=torch.int32),
        torch.full((b,), DECODE["length"], dtype=torch.int32))
    _close(dense["logits"], logits.numpy(), 1e-4, "logits")
    assert np.isfinite(dense["logits"]).all()


# ---------------------------------------------------------------------------
# (b) expert parallelism on 2 x 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    return spawn("moe", 8, tmp_path_factory.mktemp("moe"))


def _moe_layer():
    from repro_torch.configs import get_config
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    cfg = get_config("deepseek-v2-236b").reduced()
    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cpu")
    return cfg, model.moe_layers[0].moe


EP_REF = """
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.moe import moe_forward_ep

assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = get_config("deepseek-v2-236b").reduced()
p = {k: inp[k] for k in ("router", "w_gate", "w_up", "w_down")}
p["shared"] = {k: inp["shared_" + k] for k in ("w_gate", "w_up", "w_down")}
for tag, exact in (("exact", True), ("capped", False)):
    out["y_" + tag] = moe_forward_ep(p, inp["x"], cfg, mesh, exact=exact)
"""


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    from test_torch_distributed_worker import moe_input

    cfg, layer = _moe_layer()
    inp = {k: getattr(layer, k).detach().numpy()
           for k in ("router", "w_gate", "w_up", "w_down")}
    inp.update({"shared_" + k: getattr(layer.shared, k).detach().numpy()
                for k in ("w_gate", "w_up", "w_down")})
    inp["x"] = moe_input(cfg)
    return run_reference(
        EP_REF, inp, tmp_path_factory.mktemp("ep_ref"),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})


@pytest.mark.parametrize("tag", ("exact", "capped"))
def test_moe_forward_ep_matches_reference(moe, moe_ref, tag):
    _close(moe["y_" + tag], moe_ref["y_" + tag], 1e-5, tag)


def test_ep_shards_sum_to_moe_forward():
    from repro_torch.models import moe as moe_mod
    from test_torch_distributed_worker import moe_input

    cfg, layer = _moe_layer()
    x = torch.from_numpy(moe_input(cfg))
    ep = 4
    e_loc = cfg.n_experts // ep
    with torch.inference_mode():
        parts = [moe_mod._ep_shard(
            layer.router, *(w[r * e_loc:(r + 1) * e_loc]
                            for w in (layer.w_gate, layer.w_up,
                                      layer.w_down)),
            x, cfg, r, ep, exact=True) for r in range(ep)]
        y = sum(parts) + moe_mod.mlp_forward(layer.shared, x)
        want = moe_mod.moe_forward(layer, x, cfg, exact=True)
    _close(y.numpy(), want.numpy(), 1e-5, "sum of the shards")


def test_moe_first_step_matches_one_process(moe):
    """Expert-parallel gradients (the router's, the experts' shards, the
    aux loss's) against one process, where no pair drops."""
    from repro_torch.configs import get_config
    from test_torch_distributed_worker import no_drop

    _first_step_matches(moe, no_drop(get_config("deepseek-v2-236b").reduced()))


def test_moe_sharded_training_stays_finite_and_falls(moe):
    losses = moe["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 1.05, losses


# ---------------------------------------------------------------------------
# (c) the scenario grid split over 2 ranks; (d) its resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return spawn("scenario", 2, tmp_path_factory.mktemp("scenario"))


def _cells(res):
    return {"|".join(s.key): res.results[s.key] for s in res.scenarios}


def test_scenario_split_equals_one_rank(scenario):
    one = _cells(scenario_run(False))
    assert len(one) == 8
    for i in range(8):
        key = str(scenario[f"key/{i}"])
        r = one[key]
        np.testing.assert_array_equal(scenario[f"enc/{i}"],
                                      r.frontier.encoded)
        np.testing.assert_array_equal(scenario[f"vec/{i}"],
                                      r.frontier.vectors)
        assert float(scenario[f"best/{i}"]) == r.best_cost
        np.testing.assert_array_equal(scenario[f"hist/{i}"],
                                      np.asarray(r.history))


SCENARIO_REF = """
from repro.core.workload import workload
from repro.pathfinding import ScalarizationSweep, ScenarioSweep

assert len(jax.devices()) == 2
regions = {"hydro": 0.024, "eu-avg": 0.276,
           "world-avg": 0.475, "coal-heavy": 0.82}
res = ScenarioSweep(
    strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=2),
    regions=regions, norm_samples=80, shard="auto").run(
        [workload(1), workload(6)], key=5)
for i, s in enumerate(res.scenarios):
    r = res.results[s.key]
    out[f"vec/{i}"] = r.frontier.vectors
    out[f"best/{i}"] = np.array(r.best_cost)
    out[f"key/{i}"] = np.array("|".join(s.key))
"""


def test_scenario_split_matches_reference_split(scenario, tmp_path):
    ref = run_reference(
        SCENARIO_REF, None, tmp_path,
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    port = {str(scenario[f"key/{i}"]): i for i in range(8)}
    for i in range(8):
        j = port[str(ref[f"key/{i}"])]
        _close(scenario[f"best/{j}"], ref[f"best/{i}"], 1e-6, "best cost")
        got, want = scenario[f"vec/{j}"], ref[f"vec/{i}"]
        assert got.shape == want.shape
        _close(got, want, 1e-6, "frontier")


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    return spawn("scenario_resume", 2, d, str(d / "ckpt"))


def test_sharded_resume_equals_uninterrupted(resumed):
    keys = sorted(k[len("ref/enc/"):] for k in resumed
                  if k.startswith("ref/enc/"))
    assert len(keys) == 4
    for i in keys:
        for part in ("enc", "vec", "best", "hist"):
            np.testing.assert_array_equal(resumed[f"res/{part}/{i}"],
                                          resumed[f"ref/{part}/{i}"])
    assert int(resumed["interrupted"]) == 1


# ---------------------------------------------------------------------------
# (e) --model-par on the CLIs under torch.distributed.run
# ---------------------------------------------------------------------------


def _cli(module, *args, ranks=0):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", module, *args]
    if ranks:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks), "-m", module, *args]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("module,args,tag", (
    ("repro_torch.launch.train",
     ("--device", "cpu", "--reduced", "--steps", "4", "--log-every", "1",
      "--lr", "3e-2"), "step"),
    ("repro_torch.launch.serve",
     ("--device", "cpu", "--reduced", "--batch", "2", "--prompt-len", "16",
      "--gen", "4"), "[serve] sample")))
def test_model_par_cli_matches_one_device(module, args, tag):
    """4 ranks as 2 x 2 (``--model-par 2``) print what one device prints:
    the train CLI's per-step losses (to their 4 decimals), the serve
    CLI's tokens; rank 0 alone prints, and names the mesh."""
    one = _cli(module, *args)
    four = _cli(module, *args, "--model-par", "2", ranks=4)
    lines = [[ln for ln in out.splitlines() if ln.startswith(tag)]
             for out in (one, four)]
    assert lines[0] and lines[0] == lines[1]
    assert "mesh {'data': 2, 'model': 2} of 4 ranks" in four
