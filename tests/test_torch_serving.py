"""The port's pathfinding service (``repro_torch.serving``): every case of
the reference's ``tests/test_serving.py`` on the port, and the service
against a live run of the reference.

Within the port: job isolation (solo == packed, bit for bit), continuous
batching (each bucket shape is warmed exactly once, and admission,
departure and restart warm nothing: the eager counterpart of the
reference's zero-retrace checks), queue mechanics (FIFO, cancel, pause),
terminal-job GC, whole-service kill-and-resume through per-job
snapshots, and adaptive budget donation.

Against the reference: ``fold_job_key`` equal; the six-job table of
``scripts/serve_pathfinder.py`` (two bucket shapes, two workloads, three
regions) drained by the port equal to the reference service's results
(encodings equal, floats within 1e-6 relative); and the per-job
snapshots of a killed service resume in the other package's service to
the same results (a resumed archive mixes both packages' vectors, so
designs tied at one objective vector may survive in another number:
:func:`test_torch_ties.assert_same_up_to_ties`)."""
import os
import shutil
import sys

import numpy as np
import pytest

from test_torch_support import REPO, run_reference
from test_torch_ties import assert_same_up_to_ties

from repro_torch.core import workload
from repro_torch.core.regions import Region
from repro_torch.pathfinding import ScalarizationSweep, fold_job_key
from repro_torch.pathfinding.strategies import DEFAULT_SEARCH_KEY
from repro_torch.serving import JobSpec, JobState, PathfinderService

sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_serve_pathfinder as table  # noqa: E402

RTOL = 1e-6
WLS = [workload(1), workload(6)]
STRAT = ScalarizationSweep(directions=2, n_chains=2, sweeps=4)
FOLD = [(7, "job-a"), (7, "job-b"), (8, "job-a"), (DEFAULT_SEARCH_KEY, "x"),
        (2 ** 40 + 3, "wl1-mid"), (0, "")]


def make_service(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("segment", 2)
    kw.setdefault("norm_samples", 80)
    return PathfinderService(WLS, torch_device="cpu", **kw)


def spec(job_id, wl=0, ci=0.475, strategy=STRAT, **kw):
    return JobSpec(job_id=job_id, workload=WLS[wl].name,
                   strategy=strategy, region=Region(ci), **kw)


def run_solo(sp, **svc_kw):
    svc = make_service(**svc_kw)
    svc.submit(sp)
    svc.drain()
    return svc.result(sp.job_id)


def assert_bit_equal(a, b):
    assert a.history == b.history
    assert a.best_cost == b.best_cost
    assert np.array_equal(a.best_enc, b.best_enc)
    assert np.array_equal(a.frontier.vectors, b.frontier.vectors)
    assert np.array_equal(a.frontier.encoded, b.frontier.encoded)


# ---------------------------------------------------------------------------
# Per-job RNG isolation
# ---------------------------------------------------------------------------


def test_fold_job_key_deterministic_and_distinct():
    assert fold_job_key(7, "job-a") == fold_job_key(7, "job-a")
    assert fold_job_key(7, "job-a") != fold_job_key(7, "job-b")
    assert fold_job_key(7, "job-a") != fold_job_key(8, "job-a")
    # job keys are valid PRNGKey seeds (63-bit, like fold_cell_key)
    assert 0 <= fold_job_key(DEFAULT_SEARCH_KEY, "x") < 2 ** 63


def test_job_bit_identical_with_0_1_3_cotenants():
    """The same seeded job next to 0, 1 and 3 co-tenants gives the same
    history, best and frontier bits: its stream depends neither on its
    slot nor on the co-tenants' contents."""
    anchor = spec("anchor", wl=0, ci=0.276)
    results = []
    for n_cotenants in (0, 1, 3):
        svc = make_service()
        svc.submit(anchor)
        for i in range(n_cotenants):
            svc.submit(spec(f"noise-{i}", wl=i % 2,
                            ci=[0.024, 0.475, 0.82][i % 3]))
        svc.drain()
        results.append(svc.result("anchor"))
    assert_bit_equal(results[0], results[1])
    assert_bit_equal(results[0], results[2])
    noise = make_service()
    noise.submit(spec("noise-0", wl=1, ci=0.024))
    noise.drain()
    assert noise.result("noise-0").history != results[0].history


def test_job_bit_identical_in_any_slot():
    """A job admitted into slot 2 (behind two co-tenants that leave
    first) equals its solo run in slot 0."""
    svc = make_service()
    svc.submit(spec("a", strategy=ScalarizationSweep(
        directions=2, n_chains=2, sweeps=2)))
    svc.submit(spec("b", wl=1, strategy=ScalarizationSweep(
        directions=2, n_chains=2, sweeps=2)))
    svc.submit(spec("late", wl=1, ci=0.82))
    svc.step()
    assert svc._buckets[spec("late").bucket_key()].slot_jobs[2].job_id \
        == "late"
    svc.drain()
    assert_bit_equal(svc.result("late"), run_solo(spec("late", wl=1,
                                                       ci=0.82)))


# ---------------------------------------------------------------------------
# Continuous batching on the warm engine
# ---------------------------------------------------------------------------


def test_admission_into_partially_full_batch_zero_recompiles():
    """Jobs join the live batch at segment boundaries: a job admitted
    while another is mid-flight still reproduces its solo run, and
    after the bucket's one warmup no admission warms anything."""
    svc = make_service()
    svc.submit(spec("early", wl=0, ci=0.475))
    assert svc.step()           # bucket warmup + admit + first segment
    bkey = spec("early").bucket_key()
    assert svc.warmups == {bkey: 1}
    svc.submit(spec("late-0", wl=1, ci=0.024))
    svc.submit(spec("late-1", wl=0, ci=0.82))
    svc.submit(spec("late-2", wl=1, ci=0.475))
    svc.drain()
    assert svc.warmups == {bkey: 1}, "admission must warm nothing"
    for jid in ("early", "late-0", "late-1", "late-2"):
        assert svc.status(jid) is JobState.DONE
    assert_bit_equal(svc.result("early"),
                     run_solo(spec("early", wl=0, ci=0.475)))
    assert_bit_equal(svc.result("late-0"),
                     run_solo(spec("late-0", wl=1, ci=0.024)))


def test_mixed_shape_buckets_compile_once_each():
    """Two bucket shapes: each is warmed exactly once, however many jobs
    pass through it."""
    fat = ScalarizationSweep(directions=2, n_chains=4, sweeps=4)
    svc = make_service(slots=2)
    svc.submit(spec("thin", strategy=STRAT))
    svc.submit(spec("wide", strategy=fat))
    svc.step()                  # both buckets warm up
    want = {spec("thin").bucket_key(): 1,
            spec("wide", strategy=fat).bucket_key(): 1}
    assert svc.warmups == want
    svc.submit(spec("thin-2", strategy=STRAT, ci=0.82))
    svc.submit(spec("wide-2", strategy=fat, ci=0.82))
    svc.drain()
    assert svc.warmups == want
    assert svc.result("wide").sweeps == 4
    assert_bit_equal(svc.result("thin-2"),
                     run_solo(spec("thin-2", strategy=STRAT, ci=0.82)))


# ---------------------------------------------------------------------------
# Queue mechanics
# ---------------------------------------------------------------------------


def test_fifo_fairness_under_contention():
    svc = make_service(slots=1)
    order = []
    for jid in ("a", "b", "c"):
        svc.submit(spec(jid, strategy=ScalarizationSweep(
            directions=2, n_chains=2, sweeps=4)))
    while svc._work_left():
        svc.step()
        for jid in ("a", "b", "c"):
            if svc.status(jid) is JobState.RUNNING and (
                    not order or order[-1] != jid):
                order.append(jid)
    assert order == ["a", "b", "c"], "single slot must serve FIFO"
    assert all(svc.status(j) is JobState.DONE for j in "abc")


def test_cancel_releases_slot_for_next_job():
    svc = make_service(slots=1)
    long = ScalarizationSweep(directions=2, n_chains=2, sweeps=8)
    svc.submit(spec("doomed", strategy=long))
    svc.submit(spec("next", strategy=STRAT))
    svc.step()
    assert svc.status("doomed") is JobState.RUNNING
    assert svc.status("next") is JobState.PENDING
    svc.cancel("doomed")
    svc.step()                  # boundary applies the cancel
    assert svc.status("doomed") is JobState.CANCELLED
    svc.drain()
    assert svc.status("next") is JobState.DONE
    with pytest.raises(RuntimeError, match="cancelled"):
        svc.result("doomed")
    assert_bit_equal(svc.result("next"), run_solo(spec("next")))
    svc.submit(spec("never-ran"))
    svc.cancel("never-ran")
    assert svc.status("never-ran") is JobState.CANCELLED


def test_pause_at_boundary_then_resume_bit_identical():
    sp = spec("pausee", strategy=ScalarizationSweep(
        directions=2, n_chains=2, sweeps=8))
    svc = make_service()
    svc.submit(sp)
    svc.step()
    svc.pause("pausee")
    svc.step()                  # one more segment, then parked
    assert svc.status("pausee") is JobState.PAUSED
    assert not svc._work_left()         # paused jobs don't block drain
    svc.resume_job("pausee")
    svc.drain()
    assert_bit_equal(svc.result("pausee"), run_solo(sp))


def test_submit_validation():
    svc = make_service()
    with pytest.raises(ValueError, match="unknown workload"):
        svc.submit(JobSpec(job_id="x", workload="nope"))
    with pytest.raises(ValueError, match="frontier_size"):
        svc.submit(spec("x", strategy=ScalarizationSweep(
            directions=2, n_chains=2, sweeps=2, frontier_size=0)))
    svc.submit(spec("dup"))
    with pytest.raises(ValueError, match="already"):
        svc.submit(spec("dup"))
    with pytest.raises(KeyError):
        svc.status("ghost")
    with pytest.raises(RuntimeError, match="no worker"):
        svc.result("dup")
    with pytest.raises(ValueError, match="either as the unified"):
        JobSpec(job_id="y", workload=WLS[0].name, region=Region(0.3),
                carbon_intensity=0.2)
    with pytest.raises(ValueError, match="unknown comm"):
        JobSpec(job_id="y", workload=WLS[0].name, comm="torus")


def test_worker_thread_and_budget():
    """Background worker mode + the budget_sweeps total-split semantics
    (budget 12 at population 4 pays 2 whole sweeps -> rounded up to one
    2-sweep segment)."""
    with make_service().start() as svc:
        svc.submit(spec("bg", budget=12))
        res = svc.result("bg", timeout=300)
    assert res.sweeps == 2
    assert res.evaluations == 4 * (1 + 2)
    # budget validation happens at admission and surfaces as a FAILED
    # job, not a submit-time exception
    svc2 = make_service()
    svc2.submit(spec("starved", budget=3))
    svc2.drain()
    assert svc2.status("starved") is JobState.FAILED
    with pytest.raises(RuntimeError, match="failed"):
        svc2.result("starved")


def test_terminal_job_gc_evicts_oldest_past_retention_cap():
    from repro_torch.serving import JobEvictedError

    svc = make_service(retain_jobs=2)
    ids = [f"gc-{i}" for i in range(4)]
    for jid in ids:
        svc.submit(spec(jid, wl=0))
    svc.drain()
    evicted = [jid for jid in ids if jid not in svc._jobs]
    kept = [jid for jid in ids if jid in svc._jobs]
    assert len(evicted) == 2 and len(kept) == 2
    for jid in kept:
        assert svc.status(jid) is JobState.DONE
        assert svc.result(jid).job_id == jid
    for jid in evicted:
        for access in (svc.status, svc.result):
            with pytest.raises(JobEvictedError) as ei:
                access(jid)
            assert isinstance(ei.value, KeyError)
            msg = str(ei.value)
            assert "retain_jobs=2" in msg and jid in msg
            assert "resubmit" in msg
    with pytest.raises(KeyError) as ei:
        svc.status("never-submitted")
    assert not isinstance(ei.value, JobEvictedError)
    svc.submit(spec(evicted[0], wl=0))
    svc.drain()
    assert svc.status(evicted[0]) is JobState.DONE
    assert svc.result(evicted[0]).history == run_solo(
        spec(evicted[0], wl=0)).history
    with pytest.raises(ValueError, match="retain_jobs"):
        make_service(retain_jobs=0)


# ---------------------------------------------------------------------------
# Kill-and-resume of the whole service
# ---------------------------------------------------------------------------


def test_service_restart_resumes_jobs_bit_identical(tmp_path):
    specs = [spec("r0", wl=0, ci=0.475,
                  strategy=ScalarizationSweep(directions=2, n_chains=2,
                                              sweeps=8)),
             spec("r1", wl=1, ci=0.024,
                  strategy=ScalarizationSweep(directions=2, n_chains=2,
                                              sweeps=8))]
    refs = [run_solo(sp) for sp in specs]

    svc = make_service(checkpoint_root=str(tmp_path))
    for sp in specs:
        svc.submit(sp)
    svc.step()
    svc.step()                  # two boundaries snapshotted, then "die"
    del svc

    svc2 = make_service(checkpoint_root=str(tmp_path))
    for sp in specs:
        svc2.submit(sp)         # same job ids -> restore from snapshots
    svc2.drain()
    # the restarted service warms its one bucket once; restoring the
    # jobs warms nothing
    assert svc2.warmups == {specs[0].bucket_key(): 1}
    for sp, ref in zip(specs, refs):
        assert_bit_equal(svc2.result(sp.job_id), ref)
        assert svc2.result(sp.job_id).sweeps == ref.sweeps


def test_restored_complete_job_finalizes_without_rerun(tmp_path):
    sp = spec("done-before", strategy=STRAT)
    svc = make_service(checkpoint_root=str(tmp_path))
    svc.submit(sp)
    svc.drain()
    ref = svc.result("done-before")
    svc2 = make_service(checkpoint_root=str(tmp_path))
    svc2.submit(sp)
    svc2.drain()
    res = svc2.result("done-before")
    assert res.sweeps == ref.sweeps
    assert_bit_equal(res, ref)


# ---------------------------------------------------------------------------
# Adaptive per-cell budgets
# ---------------------------------------------------------------------------


def test_hypervolume_stall_donates_sweeps_to_hard_jobs():
    """A converged job's remaining sweeps move to a still-improving one;
    the drawer's trajectory is a bit-identical extension of its
    fixed-budget run."""
    eight = ScalarizationSweep(directions=2, n_chains=2, sweeps=8)
    donor = spec("donor", wl=0, strategy=eight, stall_tol=1e9,
                 stall_segments=1)
    drawer = spec("drawer", wl=1, ci=0.82, strategy=eight,
                  stall_tol=-1.0)
    svc = make_service(adaptive=True)
    svc.submit(donor)
    svc.submit(drawer)
    svc.step()
    warm = dict(svc.warmups)
    svc.drain()
    d, w = svc.result("donor"), svc.result("drawer")
    assert d.converged_early and d.sweeps == 4
    assert not w.converged_early and w.sweeps == 12
    assert d.sweeps + w.sweeps == 16        # conservation at equal total
    assert svc.donated_pool(donor.bucket_key()) == 0
    fixed = run_solo(spec("drawer", wl=1, ci=0.82, strategy=eight))
    assert w.history[:len(fixed.history)] == fixed.history
    assert len(w.history) == len(fixed.history) + 4
    # donated segments run in the warm bucket
    assert svc.warmups == warm


def test_adaptive_mean_hypervolume_not_worse_than_fixed():
    from repro_torch.pathfinding.pareto import hypervolume

    eight = ScalarizationSweep(directions=2, n_chains=2, sweeps=8)
    cells = [("c0", 0, 0.024), ("c1", 1, 0.475), ("c2", 0, 0.82)]

    def run(adaptive):
        svc = make_service(adaptive=adaptive, stall_segments=1,
                           stall_tol=0.0)
        for jid, wl, ci in cells:
            svc.submit(spec(jid, wl=wl, ci=ci, strategy=eight))
        svc.drain()
        return [svc.result(jid) for jid, *_ in cells]

    fixed, adapt = run(False), run(True)
    assert sum(r.sweeps for r in adapt) <= sum(r.sweeps for r in fixed)
    hv_f, hv_a = [], []
    for rf, ra in zip(fixed, adapt):
        ref = np.maximum(rf.frontier.reference_point(),
                         ra.frontier.reference_point())
        hv_f.append(hypervolume(rf.frontier.vectors, ref))
        hv_a.append(hypervolume(ra.frontier.vectors, ref))
    assert np.mean(hv_a) >= np.mean(hv_f) - 1e-12


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

REF = """
import shutil
from repro.core import workload
from repro.pathfinding import ScalarizationSweep
from repro.pathfinding.pareto import fold_job_key
from repro.serving import JobSpec, PathfinderService

WLS = [workload(1), workload(6)]
for i, (base, jid) in enumerate(FOLD):
    out[f"fold/{i}"] = np.asarray(fold_job_key(base, jid), np.int64)


def service(root=None):
    return PathfinderService(WLS, slots=SLOTS, segment=SEGMENT,
                             norm_samples=NORM_SAMPLES, key=KEY,
                             checkpoint_root=root)


def submit_all(svc):
    for jid, w, ci, swap in JOBS:
        svc.submit(JobSpec(job_id=jid, workload=WLS[w].name,
                           strategy=ScalarizationSweep(
                               directions=2, n_chains=2, sweeps=SWEEPS,
                               swap_every=swap), carbon_intensity=ci))


def collect(svc, tag):
    for jid, *_ in JOBS:
        r = svc.result(jid)
        out[f"{tag}/enc_{jid}"] = r.frontier.encoded
        out[f"{tag}/vec_{jid}"] = r.frontier.vectors
        out[f"{tag}/hist_{jid}"] = np.asarray(r.history)
        out[f"{tag}/best_cost_{jid}"] = np.float64(r.best_cost)
        out[f"{tag}/best_enc_{jid}"] = r.best_enc
        out[f"{tag}/sweeps_{jid}"] = np.int64(r.sweeps)


svc = service()
submit_all(svc)
svc.drain()
collect(svc, "table")
# a killed service's snapshots, two boundaries in
svc = service(str(inp["ref_root"]))
submit_all(svc)
svc.step()
svc.step()
del svc
# the port's killed service, resumed here
svc = service(str(inp["port_root"]))
submit_all(svc)
svc.drain()
collect(svc, "from_port")
"""


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    work = tmp_path_factory.mktemp("ref_serving")
    port_root = str(work / "port_root")
    svc = table.service(port_root, torch_device="cpu")
    for job in table.JOBS:
        svc.submit(table.job_spec(*job))
    svc.step()
    svc.step()
    del svc
    consts = (f"FOLD = {FOLD!r}\nJOBS = {table.JOBS!r}\n"
              f"KEY, SLOTS, SEGMENT, SWEEPS, NORM_SAMPLES = {table.KEY}, "
              f"{table.SLOTS}, {table.SEGMENT}, {table.SWEEPS}, "
              f"{table.NORM_SAMPLES}\n")
    ref = run_reference(consts + REF, {
        "ref_root": np.array(str(work / "ref_root")),
        "port_root": np.array(port_root)}, work, timeout=600)
    return dict(ref=ref, ref_root=str(work / "ref_root"), work=work)


def _table_close(got: dict, ref: dict, tag: str, ties: bool = False):
    """Every job of the table: best designs and sweeps equal, histories,
    best costs and frontier vectors within RTOL, frontier encodings
    equal (``ties``: up to tied designs, see
    :func:`test_torch_ties.assert_same_up_to_ties`)."""
    for jid, *_ in table.JOBS:
        for f in ("best_enc", "sweeps") + (() if ties else ("enc",)):
            np.testing.assert_array_equal(got[f"{f}_{jid}"],
                                          ref[f"{tag}/{f}_{jid}"])
        for f in ("hist", "best_cost") + (() if ties else ("vec",)):
            np.testing.assert_allclose(got[f"{f}_{jid}"],
                                       ref[f"{tag}/{f}_{jid}"],
                                       rtol=RTOL, atol=0)
        if ties:
            assert_same_up_to_ties(got[f"enc_{jid}"], got[f"vec_{jid}"],
                                   ref[f"{tag}/enc_{jid}"],
                                   ref[f"{tag}/vec_{jid}"], rtol=RTOL)


def test_fold_job_key_equals_the_reference(cross):
    for i, (base, jid) in enumerate(FOLD):
        assert fold_job_key(base, jid) == int(cross["ref"][f"fold/{i}"])


@pytest.fixture(scope="module")
def port_table():
    return table.serve_table("service", torch_device="cpu")


def test_six_job_table_equals_the_reference(cross, port_table):
    _table_close(port_table, cross["ref"], "table")


def test_six_job_table_solo_equals_packed(port_table):
    solo = table.serve_table("solo", torch_device="cpu")
    assert set(solo) == set(port_table)
    for k, v in solo.items():
        np.testing.assert_array_equal(v, port_table[k], err_msg=k)


@pytest.mark.cuda
def test_six_job_table_on_cuda_equals_cpu(port_table):
    """The service's ticks on the card (``prefix_select`` in the stacked
    layout at 4 slots x 4 chains) end where the CPU's do: encodings
    equal, floats within RTOL."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.prefix_gather import launch_count

    before = launch_count()
    got = table.serve_table("service", torch_device="cuda")
    assert launch_count() > before
    _table_close(got, {"cpu/" + k: v for k, v in port_table.items()}, "cpu")


def test_reference_service_snapshots_resume_in_the_port(cross, port_table):
    """The reference's killed service (two boundaries in): the port's
    service restores every job from those snapshots and ends on the
    reference's uninterrupted results (and on its own). The restored
    archives hold the reference's vectors and the new points the port's,
    which differ by an ulp: job ``wl1-mid``'s frontier holds three
    designs tied at one vector uninterrupted, and one of them after the
    cross-package resume."""
    root = str(cross["work"] / "ref_root_copy")
    shutil.copytree(cross["ref_root"], root)
    got = table.serve_table("service", checkpoint_root=root,
                            torch_device="cpu")
    _table_close(got, cross["ref"], "table", ties=True)
    _table_close(got, {"own/" + k: v for k, v in port_table.items()},
                 "own", ties=True)


def test_port_service_snapshots_resume_in_the_reference(cross):
    ref = cross["ref"]
    got = {k.split("/", 1)[1]: v for k, v in ref.items()
           if k.startswith("from_port/")}
    _table_close(got, ref, "table", ties=True)
