"""Checkpoint/resume of the port's segmented device searches
(``repro_torch.pathfinding.resume``), held against itself and against a
live run of the reference.

Within the port: every case of the reference's ``tests/test_resume.py``
on the port (segmented == monolithic bit for bit; interrupted at every
boundary and resumed bit for bit; resuming a finished run runs nothing;
a foreign fingerprint is skipped; a shrunken budget is refused; a
finished run extends; a zero-sweep run; the refusals; a subprocess that
exits at a boundary), for the single-workload engine and the stacked
scenario engine.

Against the reference: the ``device_pt``, ``scenario_pt`` and
``serve_job`` fingerprints each engine stores in its snapshots equal the
reference's byte for byte, in legacy form and in mesh-NoC + window +
price-profile form; and a reference snapshot continues in the port (and
a port snapshot in the reference) to the uninterrupted result:
encodings equal, floats within 1e-6 relative."""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from test_torch_support import REPO, SRC, run_reference

import repro_torch.pathfinding.device as device_mod
import repro_torch.pathfinding.strategies as strategies_mod
from repro_torch.core import TEMPLATES, workload
from repro_torch.core.regions import Region, diurnal_profile
from repro_torch.core.techdb import DEFAULT_DB
from repro_torch.pathfinding import (
    DesignSpace,
    ParallelTempering,
    ParetoArchive,
    Pathfinder,
    ScenarioEngine,
    ScenarioSweep,
    SearchCheckpointer,
    fit_normalizer_batched,
)
from repro_torch.pathfinding.device import get_device_evaluator
from repro_torch.serving import JobSpec, PathfinderService

RTOL = 1e-6
SPACE = DesignSpace()
WL = workload(1)
TPL = TEMPLATES["T1"]
SEED, SWEEPS, SEG, N = 11, 12, 5, 4
# the scenario engine's grid: two cells (workloads 1 and 6), n chains
SC_S, SC_SWEEPS, SC_SEG, SC_SEED = 2, 8, 3, 5
# the runs held against the reference end on whole segments, so the
# reference builds one segment program per engine
X_SWEEPS, X_SC_SWEEPS = 10, 6
# the mesh-NoC + window + price-profile forms
PROFILE_REGION = Region(0.3, electricity_price=0.12, emb_factor=1.3,
                        grid_profile=diurnal_profile(0.3, swing=0.4),
                        price_profile=diurnal_profile(0.12, swing=0.25,
                                                      peak_hour=18))
MESH = dict(comm="mesh_noc", schedule="window")


@pytest.fixture(scope="module")
def norm():
    return fit_normalizer_batched(WL, samples=400, seed=7, space=SPACE,
                                  torch_device="cpu")


@pytest.fixture(scope="module")
def dev():
    return get_device_evaluator(WL, space=SPACE, torch_device="cpu")


def _pt_args(n=N, seed=SEED):
    rng = np.random.default_rng(0)
    v0 = SPACE.sample(n, key=rng)
    ratio = (1.0 / 4000.0) ** (1.0 / (n - 1))
    temps = np.array([4000.0 * ratio ** i for i in range(n)])
    return v0, temps, seed


def _run(dev, norm, sweeps=SWEEPS, frontier=4096, **kw):
    """Engine run with an external archive; frontier large enough that
    crowding pruning never engages."""
    v0, temps, seed = _pt_args()
    archive = ParetoArchive(max_size=frontier)
    res = dev.parallel_tempering(v0, temps, sweeps, 5, seed=seed,
                                 norm=norm, template=TPL,
                                 archive=archive, **kw)
    return res, archive


class _DyingCheckpointer(SearchCheckpointer):
    """Raises (a preemption) after N segment-boundary saves; the save
    itself completes first."""

    def __init__(self, directory, die_after):
        super().__init__(directory)
        self.die_after = die_after
        self._saves = 0

    def save(self, *a, **kw):
        path = super().save(*a, **kw)
        self._saves += 1
        if self._saves >= self.die_after:
            raise KeyboardInterrupt("simulated preemption")
        return path


def _same(res, arch, ref, ref_arch):
    assert res.history == ref.history
    assert res.best_cost == ref.best_cost
    assert np.array_equal(res.best_enc, ref.best_enc)
    assert np.array_equal(res.final_enc, ref.final_enc)
    assert np.array_equal(res.final_costs, ref.final_costs)
    assert np.array_equal(arch.vectors, ref_arch.vectors)
    assert np.array_equal(arch.encoded, ref_arch.encoded)


# ---------------------------------------------------------------------------
# the single-workload engine, within the port
# ---------------------------------------------------------------------------


def test_segmented_matches_monolithic_bit_for_bit(dev, norm):
    ref, ref_arch = _run(dev, norm, segment=None)
    for segment in (5, 1, 12, 30):
        got, got_arch = _run(dev, norm, segment=segment)
        _same(got, got_arch, ref, ref_arch)


def test_interrupt_any_boundary_resume_bit_identical(dev, norm):
    """Kill after each possible boundary in turn; every resumed run must
    reproduce the uninterrupted segmented run exactly."""
    ref, ref_arch = _run(dev, norm, segment=5)  # segments 5, 5, 2
    for die_after in (1, 2, 3):
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(KeyboardInterrupt):
                _run(dev, norm, segment=5,
                     checkpoint=_DyingCheckpointer(d, die_after))
            res, arch = _run(dev, norm, segment=5,
                             checkpoint=SearchCheckpointer(d))
            _same(res, arch, ref, ref_arch)


def test_resume_after_completion_is_a_noop(dev, norm, monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        a, arch_a = _run(dev, norm, sweeps=10, segment=5,
                         checkpoint=SearchCheckpointer(d))
        calls = []
        real = device_mod._propose
        monkeypatch.setattr(device_mod, "_propose",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        b, arch_b = _run(dev, norm, sweeps=10, segment=5,
                         checkpoint=SearchCheckpointer(d))
        # restored at sweep 10: no sweep runs, same result
        assert calls == []
        assert b.history == a.history and b.best_cost == a.best_cost
        assert np.array_equal(arch_b.vectors, arch_a.vectors)


def test_fingerprint_mismatch_rejected(dev, norm):
    with tempfile.TemporaryDirectory() as d:
        _run(dev, norm, sweeps=10, segment=5,
             checkpoint=SearchCheckpointer(d))
        v0, temps, _ = _pt_args()
        with pytest.raises(ValueError, match="different search"):
            dev.parallel_tempering(
                v0, temps, 10, 5, seed=999, norm=norm, template=TPL,
                archive=ParetoArchive(max_size=64), segment=5,
                checkpoint=SearchCheckpointer(d))
        # a config mismatch is never misread as corruption: the rejected
        # snapshots stay on disk for the original config
        assert SearchCheckpointer(d).manager.all_steps()
        with pytest.raises(ValueError, match="different search"):
            dev.parallel_tempering(
                v0, temps, 10, 5, seed=SEED, norm=norm, template=TPL,
                collect_samples=False, segment=5,
                checkpoint=SearchCheckpointer(d))
        assert SearchCheckpointer(d).manager.all_steps()
        # resume=False ignores the stale state and starts fresh
        res = dev.parallel_tempering(
            v0, temps, 10, 5, seed=999, norm=norm, template=TPL,
            archive=ParetoArchive(max_size=64), segment=5,
            checkpoint=SearchCheckpointer(d), resume=False)
        assert len(res.history) == 11


def test_zero_sweep_run_returns_seed_only(norm):
    """budget == population clamps sweeps to 0; the segmented loop
    degrades to the seed evaluation."""
    pf = Pathfinder(WL, TPL, norm=norm, space=SPACE, torch_device="cpu")
    res = pf.search(strategy=ParallelTempering(n_chains=4, sweeps=50),
                    budget=4, key=3)
    assert res.evaluations == 4
    assert len(res.history) == 1
    assert len(res.frontier) >= 1


def test_resume_shrunken_budget_rejected(dev, norm):
    with tempfile.TemporaryDirectory() as d:
        _run(dev, norm, sweeps=10, segment=5,
             checkpoint=SearchCheckpointer(d))
        with pytest.raises(ValueError, match="shrinking a resumed"):
            _run(dev, norm, sweeps=5, segment=5,
                 checkpoint=SearchCheckpointer(d))


def test_resume_extends_finished_run(dev, norm):
    """A finished segment=None run resumes under a larger sweep budget
    and continues its stream (the fingerprint hashes the segment knob,
    not the derived chunk size)."""
    with tempfile.TemporaryDirectory() as d:
        a, _ = _run(dev, norm, sweeps=6, segment=None,
                    checkpoint=SearchCheckpointer(d))
        b, _ = _run(dev, norm, sweeps=10, segment=None,
                    checkpoint=SearchCheckpointer(d))
        full, _ = _run(dev, norm, sweeps=10, segment=None)
        assert len(a.history) == 7 and len(b.history) == 11
        assert b.history[:7] == a.history
        assert b.history == full.history


def test_checkpoint_with_samples_needs_archive(dev, norm):
    v0, temps, seed = _pt_args()
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="requires an archive"):
            dev.parallel_tempering(v0, temps, 4, 5, seed=seed, norm=norm,
                                   template=TPL,
                                   checkpoint=SearchCheckpointer(d))


def test_restore_skips_foreign_fingerprint_steps():
    """A stale snapshot of another configuration must not block resume:
    restore falls back to the newest snapshot of *this* search and
    leaves the foreign one on disk."""
    from repro_torch.pathfinding.resume import search_fingerprint

    carry = {"x": np.arange(4.0)}
    with tempfile.TemporaryDirectory() as d:
        ck = SearchCheckpointer(d)
        fp_a = search_fingerprint("t", seed=np.int64(1))
        fp_b = search_fingerprint("t", seed=np.int64(2))
        ck.save(4, {"x": np.full(4, 2.0)}, None, np.arange(5.0), fp_b)
        ck.save(10, {"x": np.full(4, 1.0)}, None, np.arange(11.0), fp_a)
        got = SearchCheckpointer(d).restore(carry, None, fp_b)
        assert got is not None and got.sweep_done == 4
        np.testing.assert_array_equal(got.carry["x"], np.full(4, 2.0))
        assert SearchCheckpointer(d).manager.all_steps() == [4, 10]
        assert SearchCheckpointer(d).restore(carry, None,
                                             fp_a).sweep_done == 10
        with pytest.raises(ValueError, match="different search"):
            SearchCheckpointer(d).restore(
                carry, None, search_fingerprint("t", seed=np.int64(3)))
        # a foreign snapshot of another carry shape is skipped too
        ck.save(20, {"x": np.zeros(9)}, None, np.arange(3.0),
                search_fingerprint("t", seed=np.int64(4)))
        got = SearchCheckpointer(d).restore(carry, None, fp_b)
        assert got is not None and got.sweep_done == 4
        assert SearchCheckpointer(d).manager.all_steps() == [4, 10, 20]


def test_checkpoint_dir_requires_device_engine(norm):
    pf = Pathfinder(WL, TPL, norm=norm, space=SPACE, device=False,
                    torch_device="cpu")
    strat = ParallelTempering(n_chains=4, sweeps=4,
                              checkpoint_dir="/tmp/nonexistent-ok")
    with pytest.raises(ValueError, match="device engine"):
        pf.search(strategy=strat, key=1)


def test_scenario_checkpoint_dir_requires_device_path():
    with pytest.raises(ValueError, match="device path"):
        ScenarioSweep().run(WL, device=False,
                            checkpoint_dir="/tmp/nonexistent-ok",
                            torch_device="cpu")


def test_record_trace_cannot_checkpoint(dev, norm):
    v0, temps, seed = _pt_args()
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="record_trace"):
            dev.parallel_tempering(v0, temps, 4, 5, seed=seed, norm=norm,
                                   template=TPL, record_trace=True,
                                   checkpoint=SearchCheckpointer(d))


def test_pt_strategy_checkpoint_surface(norm, monkeypatch):
    """The ParallelTempering facade: an interrupted strategy run plus a
    resumed one equals the uninterrupted run (frontier bit for bit)."""
    pf = Pathfinder(WL, TPL, norm=norm, space=SPACE, torch_device="cpu")

    def mk(d=None):
        return ParallelTempering(n_chains=4, sweeps=12, segment=4,
                                 frontier_size=4096, checkpoint_dir=d)

    ref = pf.search(strategy=mk(), key=3)
    with tempfile.TemporaryDirectory() as d:
        with monkeypatch.context() as m:
            m.setattr(strategies_mod, "_checkpointer",
                      lambda cd: _DyingCheckpointer(cd, die_after=2)
                      if cd is not None else None)
            with pytest.raises(KeyboardInterrupt):
                pf.search(strategy=mk(d), key=3)
        assert SearchCheckpointer(d).manager.all_steps() == [4, 8]
        res = pf.search(strategy=mk(d), key=3)
    assert res.history == ref.history
    assert res.best_cost == ref.best_cost
    assert np.array_equal(res.frontier.vectors, ref.frontier.vectors)
    assert np.array_equal(res.frontier.encoded, ref.frontier.encoded)
    assert res.best == ref.best


def test_scenario_sweep_resume_subprocess_boundary_exit(tmp_path):
    """Real process death: a scenario-sweep subprocess exits hard after
    its first boundary, a second invocation resumes, and the frontiers
    equal an uninterrupted run's bit for bit."""
    script = os.path.join(REPO, "scripts", "torch_resume_worker.py")
    env = dict(os.environ, PYTHONPATH=SRC)
    ckpt, out_ref, out_res = (str(tmp_path / x)
                              for x in ("ckpt", "ref.npz", "res.npz"))

    def run(*a):
        return subprocess.run(
            [sys.executable, script, "run", "--torch-device", "cpu", *a],
            env=env, timeout=600, capture_output=True, text=True)

    ref = run("--out", out_ref)
    assert ref.returncode == 0, ref.stderr[-2000:]
    first = run("--checkpoint-dir", ckpt, "--max-segments", "1")
    assert first.returncode == 3, (first.returncode, first.stderr[-2000:])
    assert SearchCheckpointer(ckpt).manager.all_steps() == [2]
    resumed = run("--checkpoint-dir", ckpt, "--out", out_res)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    a, b = np.load(out_ref), np.load(out_res)
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the stacked scenario engine, within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sc_engine():
    return ScenarioEngine((workload(1), workload(6)), space=SPACE,
                          torch_device="cpu")


def _sc_inputs(space=SPACE, S=SC_S, n=N):
    rng = np.random.default_rng(3)
    v0 = np.stack([space.sample(n, key=rng) for _ in range(S)])
    ladder = 5.0 * (0.01 ** (np.arange(n) / (n - 1)))
    return dict(
        v0=v0, temps=np.tile(ladder, (S, 1)),
        mins=0.5 + rng.random((S, 6)), medians=1.0 + rng.random((S, 6)),
        weights=rng.random((S, n, 6)),
        pair_mask=np.ones((S, n - 1), bool),
        ci=np.array([0.024, 0.82, 0.3, 0.5][:S]),
        widx=np.arange(S) % 2)


def _sc_run(engine, inp, sweeps=SC_SWEEPS, **kw):
    archives = [ParetoArchive(max_size=4096) for _ in range(len(inp["v0"]))]
    res = engine.parallel_tempering(
        inp["v0"], inp["temps"], sweeps, 2, seed=SC_SEED,
        mins=inp["mins"], medians=inp["medians"], weights=inp["weights"],
        pair_mask=inp["pair_mask"], ci=inp["ci"], widx=inp["widx"],
        archives=archives, **kw)
    return res, archives


def _sc_same(res, arch, ref, ref_arch):
    for f in ("history", "best_enc", "best_cost", "final_enc",
              "final_costs"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))
    for a, b in zip(arch, ref_arch):
        np.testing.assert_array_equal(a.encoded, b.encoded)
        np.testing.assert_array_equal(a.vectors, b.vectors)


def test_scenario_interrupt_any_boundary_resume_bit_identical(sc_engine):
    inp = _sc_inputs()
    mono, mono_arch = _sc_run(sc_engine, inp)
    ref, ref_arch = _sc_run(sc_engine, inp, segment=SC_SEG)  # 3, 3, 2
    _sc_same(ref, ref_arch, mono, mono_arch)
    for die_after in (1, 2, 3):
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(KeyboardInterrupt):
                _sc_run(sc_engine, inp, segment=SC_SEG,
                        checkpoint=_DyingCheckpointer(d, die_after))
            res, arch = _sc_run(sc_engine, inp, segment=SC_SEG,
                                checkpoint=SearchCheckpointer(d))
            _sc_same(res, arch, ref, ref_arch)


def test_scenario_snapshot_tree(sc_engine, tmp_path):
    """The scenario snapshot holds the reference's tree: uint32 key
    words ``[S, 2]``, per-cell sweep counters ``[S]``, an ``[S, k]``
    history and int32 rows."""
    from repro_torch.checkpoint import load_checkpoint

    inp = _sc_inputs()
    _sc_run(sc_engine, inp, sweeps=3, checkpoint=SearchCheckpointer(
        str(tmp_path)))
    like = {"carry": {"v": np.zeros((SC_S, N, SPACE.width), np.int32),
                      "costs": np.zeros((SC_S, N)),
                      "best_v": np.zeros((SC_S, SPACE.width), np.int32),
                      "best_c": np.zeros(SC_S),
                      "keys": np.zeros((SC_S, 2), np.uint32)},
            "history": np.zeros((SC_S, 4)),
            "sweep_done": np.zeros(SC_S, np.int64),
            "fingerprint": np.zeros(1, np.uint64)}
    _, t = load_checkpoint(str(tmp_path / "step_00000003"), like)
    assert t["carry"]["keys"].dtype == np.uint32
    assert t["carry"]["v"].dtype == np.int32
    np.testing.assert_array_equal(t["sweep_done"], [3, 3])


def test_scenario_resume_shrunken_budget_rejected(sc_engine, tmp_path):
    inp = _sc_inputs()
    _sc_run(sc_engine, inp, sweeps=6, segment=3,
            checkpoint=SearchCheckpointer(str(tmp_path)))
    with pytest.raises(ValueError, match="shrinking a resumed"):
        _sc_run(sc_engine, inp, sweeps=3, segment=3,
                checkpoint=SearchCheckpointer(str(tmp_path)))


# ---------------------------------------------------------------------------
# against the reference: fingerprints and cross-package resume
# ---------------------------------------------------------------------------

REF = """
import dataclasses, shutil
from repro.core import TEMPLATES, workload
from repro.core.regions import Region
from repro.core.techdb import DEFAULT_DB
from repro.core.templates import METRIC_FIELDS, Normalizer
from repro.pathfinding import DesignSpace, ParetoArchive, SearchCheckpointer
import repro.pathfinding.resume as resume_mod
from repro.pathfinding.device import ScenarioEngine, get_device_evaluator
from repro.serving import JobSpec, PathfinderService

TPL = TEMPLATES["T1"]
norm = Normalizer(dict(zip(METRIC_FIELDS, inp["norm_m"].tolist())),
                  dict(zip(METRIC_FIELDS, inp["norm_d"].tolist())))


class Dying(SearchCheckpointer):
    def __init__(self, d, n):
        super().__init__(d)
        self.n, self.k = n, 0

    def save(self, *a, **kw):
        p = super().save(*a, **kw)
        self.k += 1
        if self.k >= self.n:
            raise KeyboardInterrupt
        return p


def save_pt(tag, res, arch):
    out[tag + "/history"] = np.asarray(res.history)
    out[tag + "/best_enc"] = res.best_enc
    out[tag + "/best_cost"] = np.asarray(res.best_cost)
    out[tag + "/final_enc"] = res.final_enc
    out[tag + "/final_costs"] = res.final_costs
    archs = arch if isinstance(arch, list) else [arch]
    for i, a in enumerate(archs):
        out[f"{tag}/arch/{i}/enc"] = a.encoded
        out[f"{tag}/arch/{i}/vec"] = a.vectors


# -- device_pt: uninterrupted, a snapshot at sweep 5, the port's resumed
dev = get_device_evaluator(workload(1), space=DesignSpace())


def pt(**kw):
    arch = ParetoArchive(max_size=4096)
    res = dev.parallel_tempering(inp["pt_v0"], inp["pt_temps"], SWEEPS, 5,
                                 seed=SEED, norm=norm, template=TPL,
                                 archive=arch, segment=SEG, **kw)
    return res, arch


save_pt("pt/full", *pt())
try:
    pt(checkpoint=Dying(str(inp["ref_pt_dir"]), 1))
except KeyboardInterrupt:
    pass
save_pt("pt/from_port", *pt(checkpoint=SearchCheckpointer(
    str(inp["port_pt_dir"]))))

# -- scenario_pt, the same three runs
eng = ScenarioEngine((workload(1), workload(6)), space=DesignSpace())


def sc(**kw):
    archs = [ParetoArchive(max_size=4096) for _ in range(SC_S)]
    res = eng.parallel_tempering(
        inp["sc_v0"], inp["sc_temps"], SC_SWEEPS, 2, seed=SC_SEED,
        mins=inp["sc_mins"], medians=inp["sc_medians"],
        weights=inp["sc_weights"], pair_mask=inp["sc_pair_mask"],
        ci=inp["sc_ci"], widx=inp["sc_widx"], archives=archs,
        segment=SC_SEG, **kw)
    return res, archs


save_pt("sc/full", *sc())
try:
    sc(checkpoint=Dying(str(inp["ref_sc_dir"]), 1))
except KeyboardInterrupt:
    pass
save_pt("sc/from_port", *sc(checkpoint=SearchCheckpointer(
    str(inp["port_sc_dir"]))))


# -- the fingerprints of the mesh-NoC + window + price-profile forms and
# of serve_job, captured as the engines build them (the run stops there)
class Captured(Exception):
    pass


real_fp = resume_mod.segment_fingerprint


def capture(kind, **kw):
    out["fp/" + CURRENT[0]] = real_fp(kind, **kw)
    raise Captured


resume_mod.segment_fingerprint = capture
CURRENT = [None]
region = Region(**REGION)
mspace = DesignSpace(comm="mesh_noc", schedule="window")
mdb = dataclasses.replace(DEFAULT_DB, **region.db_overrides())
CURRENT[0] = "device_pt/mesh"
try:
    get_device_evaluator(workload(1), mdb, space=DesignSpace(
        mdb, comm="mesh_noc", schedule="window")).parallel_tempering(
        inp["mpt_v0"], inp["pt_temps"], 1, 5, seed=SEED, norm=norm,
        template=TPL, archive=ParetoArchive(), segment=SEG,
        checkpoint=SearchCheckpointer(str(inp["tmp"]) + "/a"))
except Captured:
    pass
meng = ScenarioEngine((workload(1), workload(6)), space=mspace)
CURRENT[0] = "scenario_pt/mesh"
try:
    meng.parallel_tempering(
        inp["msc_v0"], inp["sc_temps"], 1, 2, seed=SC_SEED,
        mins=inp["sc_mins"], medians=inp["sc_medians"],
        weights=inp["sc_weights"], pair_mask=inp["sc_pair_mask"],
        ci=inp["sc_ci"], widx=inp["sc_widx"], price=inp["msc_price"],
        embf=inp["msc_embf"], profile=inp["msc_profile"],
        pprofile=inp["msc_pprofile"], noc_on=inp["msc_noc"],
        sched_on=inp["msc_sched"],
        archives=[ParetoArchive() for _ in range(SC_S)],
        checkpoint=SearchCheckpointer(str(inp["tmp"]) + "/b"))
except Captured:
    pass
PathfinderService._warmup = lambda self, b: None
for form, kw in (("legacy", dict(region=Region(0.3))),
                 ("mesh", dict(region=region, comm="mesh_noc",
                               schedule="window"))):
    CURRENT[0] = "serve_job/" + form
    svc = PathfinderService([workload(1), workload(6)], slots=2,
                            segment=2, norm_samples=60, key=5,
                            checkpoint_root=str(inp["tmp"]) + "/s" + form)
    from repro.pathfinding import ScalarizationSweep
    svc.submit(JobSpec(job_id="fp-" + form, workload=workload(6).name,
                       strategy=ScalarizationSweep(directions=2, n_chains=2,
                                                   sweeps=4), **kw))
    svc.step()
"""


def _mesh_inputs():
    mspace = DesignSpace(**MESH)
    rng = np.random.default_rng(8)
    S = SC_S
    return dict(
        mpt_v0=mspace.sample(N, key=rng),
        msc_v0=np.stack([mspace.sample(N, key=rng) for _ in range(S)]),
        msc_price=np.array([0.12, 0.05]), msc_embf=np.array([1.3, 0.9]),
        msc_profile=np.stack([diurnal_profile(0.024, swing=0.4),
                              diurnal_profile(0.82, peak_hour=7)]),
        msc_pprofile=np.stack([diurnal_profile(0.12, swing=0.25),
                               np.full(24, 0.05)]),
        msc_noc=np.array([1.0, 0.0]), msc_sched=np.array([1.0, 1.0]))


@pytest.fixture(scope="module")
def cross(tmp_path_factory, dev, norm, sc_engine):
    """The port's snapshots at the first boundary (device_pt, scenario),
    then one reference run that continues them, writes its own and
    captures its fingerprints."""
    work = tmp_path_factory.mktemp("ref_resume")
    v0, temps, _ = _pt_args()
    sc = _sc_inputs()
    port_pt, port_sc = str(work / "port_pt"), str(work / "port_sc")
    with pytest.raises(KeyboardInterrupt):
        _run(dev, norm, sweeps=X_SWEEPS, segment=SEG,
             checkpoint=_DyingCheckpointer(port_pt, 1))
    with pytest.raises(KeyboardInterrupt):
        _sc_run(sc_engine, sc, sweeps=X_SC_SWEEPS, segment=SC_SEG,
                checkpoint=_DyingCheckpointer(port_sc, 1))
    port_snapshots = {}
    for tag, d in (("pt", port_pt), ("sc", port_sc)):
        keep = str(work / f"{tag}_kept")
        shutil.copytree(d, keep)
        port_snapshots[tag] = keep
    mins, meds = norm.weights_arrays()
    inputs = dict(norm_m=mins, norm_d=meds, pt_v0=v0, pt_temps=temps,
                  ref_pt_dir=np.array(str(work / "ref_pt")),
                  port_pt_dir=np.array(port_pt),
                  ref_sc_dir=np.array(str(work / "ref_sc")),
                  port_sc_dir=np.array(port_sc),
                  tmp=np.array(str(work / "fp")),
                  **{"sc_" + k: v for k, v in sc.items()}, **_mesh_inputs())
    consts = (f"SEED, SWEEPS, SEG = {SEED}, {X_SWEEPS}, {SEG}\n"
              f"SC_S, SC_SWEEPS, SC_SEG, SC_SEED = {SC_S}, {X_SC_SWEEPS}, "
              f"{SC_SEG}, {SC_SEED}\n"
              f"REGION = dict(carbon_intensity=0.3, electricity_price=0.12,"
              f" emb_factor=1.3, grid_profile={PROFILE_REGION.grid_profile!r},"
              f" price_profile={PROFILE_REGION.price_profile!r})\n")
    ref = run_reference(consts + REF, inputs, work, timeout=600)
    return dict(ref=ref, ref_pt=str(work / "ref_pt"),
                ref_sc=str(work / "ref_sc"), port=port_snapshots,
                work=work)


def _close(got, ref, tag):
    """A run against the reference's arrays under ``tag``: encodings
    equal, floats within RTOL."""
    np.testing.assert_array_equal(got.best_enc, ref[tag + "/best_enc"])
    np.testing.assert_array_equal(got.final_enc, ref[tag + "/final_enc"])
    for f in ("history", "best_cost", "final_costs"):
        np.testing.assert_allclose(np.asarray(getattr(got, f), np.float64),
                                   ref[f"{tag}/{f}"], rtol=RTOL, atol=0)


def _close_arch(archs, ref, tag):
    for i, a in enumerate(archs if isinstance(archs, list) else [archs]):
        np.testing.assert_array_equal(a.encoded, ref[f"{tag}/arch/{i}/enc"])
        np.testing.assert_allclose(a.vectors, ref[f"{tag}/arch/{i}/vec"],
                                   rtol=RTOL, atol=0)


def _fingerprint(directory):
    from repro_torch.checkpoint import load_checkpoint

    steps = SearchCheckpointer(directory).manager.all_steps()
    _, t = load_checkpoint(SearchCheckpointer(directory).manager.step_path(
        steps[0]), {"fingerprint": np.zeros(1, np.uint64)})
    return t["fingerprint"]


@pytest.mark.parametrize("kind", ["device_pt", "scenario_pt"])
def test_legacy_fingerprints_equal_the_reference(cross, kind):
    """The reference's snapshot and the port's, written by the same
    search, carry the same fingerprint bytes."""
    tag = "pt" if kind == "device_pt" else "sc"
    np.testing.assert_array_equal(_fingerprint(cross["port"][tag]),
                                  _fingerprint(cross["ref_" + tag]))


def _port_mesh_fingerprint(kind, tmp_path, norm):
    m = _mesh_inputs()
    d = str(tmp_path / kind)
    if kind == "device_pt":
        db = dataclasses.replace(DEFAULT_DB,
                                 **PROFILE_REGION.db_overrides())
        ev = get_device_evaluator(WL, db, space=DesignSpace(db, **MESH),
                                  torch_device="cpu")
        ev.parallel_tempering(m["mpt_v0"], _pt_args()[1], 1, 5, seed=SEED,
                              norm=norm, template=TPL,
                              archive=ParetoArchive(), segment=SEG,
                              checkpoint=SearchCheckpointer(d))
    elif kind == "scenario_pt":
        sc = _sc_inputs()
        eng = ScenarioEngine((workload(1), workload(6)),
                             space=DesignSpace(**MESH), torch_device="cpu")
        eng.parallel_tempering(
            m["msc_v0"], sc["temps"], 1, 2, seed=SC_SEED, mins=sc["mins"],
            medians=sc["medians"], weights=sc["weights"],
            pair_mask=sc["pair_mask"], ci=sc["ci"], widx=sc["widx"],
            price=m["msc_price"], embf=m["msc_embf"],
            profile=m["msc_profile"], pprofile=m["msc_pprofile"],
            noc_on=m["msc_noc"], sched_on=m["msc_sched"],
            archives=[ParetoArchive() for _ in range(SC_S)],
            checkpoint=SearchCheckpointer(d))
    else:
        from repro_torch.pathfinding import ScalarizationSweep

        form = kind.split("/")[1]
        kw = (dict(region=Region(0.3)) if form == "legacy" else
              dict(region=PROFILE_REGION, **MESH))
        svc = PathfinderService([workload(1), workload(6)], slots=2,
                                segment=2, norm_samples=60, key=5,
                                checkpoint_root=d, torch_device="cpu")
        svc.submit(JobSpec(job_id="fp-" + form, workload=workload(6).name,
                           strategy=ScalarizationSweep(
                               directions=2, n_chains=2, sweeps=4), **kw))
        svc.step()
        d = os.path.join(d, "fp-" + form)
    return _fingerprint(d)


@pytest.mark.parametrize("kind", ["device_pt", "scenario_pt",
                                  "serve_job/legacy", "serve_job/mesh"])
def test_fingerprints_equal_the_reference(cross, kind, tmp_path, norm):
    """mesh-NoC + window + price-profile forms of ``device_pt`` and
    ``scenario_pt`` (comm, schedule, noc_on, sched_on and pprofile
    enter), and ``serve_job`` in both forms: the port's snapshot carries
    the fingerprint the reference's engine builds for the same job."""
    key = "fp/" + (kind + "/mesh" if "/" not in kind else kind)
    got = _port_mesh_fingerprint(kind, tmp_path, norm)
    np.testing.assert_array_equal(got, cross["ref"][key])


def test_reference_snapshot_continues_in_the_port(cross, dev, norm):
    """device_pt: the reference's snapshot at sweep 5 (of 10) resumed by the
    port ends where the reference's uninterrupted run (and the port's)
    ends."""
    full, full_arch = _run(dev, norm, sweeps=X_SWEEPS, segment=SEG)
    res, arch = _run(dev, norm, sweeps=X_SWEEPS, segment=SEG,
                     checkpoint=SearchCheckpointer(cross["ref_pt"]))
    ref = cross["ref"]
    _close(res, ref, "pt/full")
    _close_arch(arch, ref, "pt/full")
    _close(full, ref, "pt/full")
    np.testing.assert_array_equal(res.final_enc, full.final_enc)
    np.testing.assert_allclose(res.history, full.history, rtol=RTOL, atol=0)


def test_port_snapshot_continues_in_the_reference(cross):
    ref = cross["ref"]
    for f in ("best_enc", "final_enc"):
        np.testing.assert_array_equal(ref["pt/from_port/" + f],
                                      ref["pt/full/" + f])
    for f in ("history", "best_cost", "final_costs"):
        np.testing.assert_allclose(ref["pt/from_port/" + f],
                                   ref["pt/full/" + f], rtol=RTOL, atol=0)
    np.testing.assert_array_equal(ref["pt/from_port/arch/0/enc"],
                                  ref["pt/full/arch/0/enc"])


def test_scenario_snapshots_continue_across_packages(cross, sc_engine):
    """scenario_pt both ways: the reference's snapshot at sweep 3 (of 6) in the
    port, the port's in the reference, each to the uninterrupted
    result."""
    ref = cross["ref"]
    inp = _sc_inputs()
    res, archs = _sc_run(sc_engine, inp, sweeps=X_SC_SWEEPS, segment=SC_SEG,
                         checkpoint=SearchCheckpointer(cross["ref_sc"]))
    _close(res, ref, "sc/full")
    _close_arch(archs, ref, "sc/full")
    for f in ("best_enc", "final_enc"):
        np.testing.assert_array_equal(ref["sc/from_port/" + f],
                                      ref["sc/full/" + f])
    for f in ("history", "best_cost", "final_costs"):
        np.testing.assert_allclose(ref["sc/from_port/" + f],
                                   ref["sc/full/" + f], rtol=RTOL, atol=0)
    for i in range(SC_S):
        np.testing.assert_array_equal(ref[f"sc/from_port/arch/{i}/enc"],
                                      ref[f"sc/full/arch/{i}/enc"])
