"""The training path: ``train_step``, ``launch/train.py``'s restart
supervision and its checkpoints, against the reference.

- Five steps of the reduced ``smollm-135m`` (2 layers, d_model 64,
  vocabulary 128; batch 4 x 32 tokens from each package's own synthetic
  pipeline, AdamW with warmup 2 of 5 steps, remat on) from the
  reference's initial weights, against the reference's step:
  ``jax.value_and_grad(loss_fn)`` then ``adamw.apply_updates``, which is
  the body of its ``build_train_step`` without the sharding constraints
  (no-ops on one device). The loss, the global gradient norm and the
  learning rate of every step within 1e-5 relative; the parameters after
  five steps within 1e-5 of each leaf's max |value| (measured on the
  CPU: the step metrics at most 2.1e-7, the parameters 4.5e-6: Adam
  divides each gradient by its own running magnitude, so a small
  gradient's summation noise moves its update by more than its share of
  the leaf's largest gradient).
- A checkpoint the reference's ``CheckpointManager`` wrote after two
  steps, restored by the port's ``restore_state``: parameters, moments
  and step equal to the bit; three more port steps from it end within
  the tolerance above of the reference's five-step parameters. A
  checkpoint the port's ``save_state`` wrote, restored by the
  reference's manager: equal to the bit.
- ``train`` with injected failures (one before the first checkpoint,
  which restarts from the initial weights, and two after it) ends with
  the parameters and moments of the fault-free run, bit for bit.
- The CLI: exits 0 with a falling loss on the CPU, for smollm and for
  the reduced moe (``deepseek-v2-236b``, ``llama4-maverick-400b-a17b``),
  ssm (``rwkv6-3b``) and hybrid (``recurrentgemma-9b``) configs; raises
  without a GPU unless given ``--device cpu``. For those four too,
  ``train`` with injected failures ends equal to the bit to the
  fault-free run. Their steps are held against the reference in
  ``tests/test_torch_train_moe.py`` and
  ``tests/test_torch_train_recurrent.py``.
"""
import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import (
    adamw_state_from_reference,
    lm_params_from_reference,
    lm_params_to_reference,
    lm_reference_shapes,
)
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import train_step
from repro_torch.models.transformer import init_model
from repro_torch.optim import adamw

RTOL = 1e-5
STEPS, BATCH, SEQ, CKPT_STEP = 5, 4, 32, 2
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=STEPS)


def _cfg():
    return get_config("smollm-135m").reduced()


REF = FLAT + """
import jax.numpy as jnp
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.data import DataConfig, SyntheticTokenPipeline
from repro.models.transformer import init_model, loss_fn
from repro.optim import adamw

cfg = get_config("smollm-135m").reduced()
params = init_model(jax.random.PRNGKey(0), cfg)
out.update(flat(params, "p0/"))
opt = adamw.AdamWConfig(**OPT)
state = adamw.init(params, opt)
pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH))


@jax.jit
def step(params, state, batch):
    loss, grads = jax.value_and_grad(loss_fn)(params, cfg, batch, remat=True)
    params, state, m = adamw.apply_updates(params, grads, state, opt)
    m["loss"] = loss
    return params, state, m


for i in range(STEPS):
    params, state, m = step(params, state, pipe.batch(i))
    out[f"loss{i}"], out[f"gnorm{i}"], out[f"lr{i}"] = (
        m["loss"], m["grad_norm"], m["lr"])
    if i + 1 == CKPT_STEP:
        tree = {"params": params, "opt_mu": state.mu, "opt_nu": state.nu,
                "opt_step": state.step}
        CheckpointManager(REF_DIR).save(CKPT_STEP, tree)
        out.update(flat(tree["params"], "ck/params/"))
        out.update(flat(tree["opt_mu"], "ck/mu/"))
out.update(flat(params, "p5/"))
like = {"params": params, "opt_mu": state.mu, "opt_nu": state.nu,
        "opt_step": state.step}
got_step, tree = CheckpointManager(PORT_DIR).restore(like)
out["port_ck/step"] = np.array(got_step)
out["port_ck/opt_step"] = tree["opt_step"]
out.update(flat(tree["params"], "port_ck/params/"))
out.update(flat(tree["opt_nu"], "port_ck/nu/"))
"""


def _port_state(steps):
    """A port model and optimizer state after ``steps`` steps from the
    port's own seed (the checkpoint the reference restores)."""
    cfg = _cfg()
    model = init_model(cfg, torch_device="cpu", trainable=True, seed=3)
    opt_cfg = adamw.AdamWConfig(**OPT)
    state = adamw.init(dict(model.named_parameters()), opt_cfg)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH),
                                  torch_device="cpu")
    for i in range(steps):
        state, _ = train_step(model, state, pipe.batch(i), opt_cfg)
    return model, state


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return (str(tmp_path_factory.mktemp("ref_ckpt")),
            str(tmp_path_factory.mktemp("port_ckpt")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory, dirs):
    ref_dir, port_dir = dirs
    model, state = _port_state(1)
    train_mod.save_state(CheckpointManager(port_dir), 1, model, state)
    consts = (f"OPT = {OPT!r}\nSTEPS, BATCH, SEQ, CKPT_STEP = {STEPS}, "
              f"{BATCH}, {SEQ}, {CKPT_STEP}\nREF_DIR = {ref_dir!r}\n"
              f"PORT_DIR = {port_dir!r}\n")
    return run_reference(consts + REF, None,
                         tmp_path_factory.mktemp("ref_train"))


def _model_from(ref, prefix):
    cfg = _cfg()
    model = init_model(cfg, torch_device="cpu", trainable=True)
    model.load_state_dict(lm_params_from_reference(nest(ref, prefix), cfg))
    return model


def _pipe():
    return SyntheticTokenPipeline(DataConfig(_cfg().vocab, SEQ, BATCH),
                                  torch_device="cpu")


def _close(got, want, what, rtol=RTOL):
    got = got.detach().float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


def _params_close(model, ref, prefix):
    want = lm_params_from_reference(nest(ref, prefix), _cfg())
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def test_five_steps_match_reference(ref):
    model = _model_from(ref, "p0/")
    opt_cfg = adamw.AdamWConfig(**OPT)
    state = adamw.init(dict(model.named_parameters()), opt_cfg)
    pipe = _pipe()
    for i in range(STEPS):
        state, m = train_step(model, state, pipe.batch(i), opt_cfg)
        for key, name in (("loss", "loss"), ("grad_norm", "gnorm"),
                          ("lr", "lr")):
            _close(m[key], ref[f"{name}{i}"], f"step {i} {key}")
    assert int(state.step) == STEPS
    _params_close(model, ref, "p5/")
    # the loss falls over the five steps
    assert float(ref[f"loss{STEPS - 1}"]) < float(ref["loss0"])


def test_reference_checkpoint_restores_into_the_port(ref, dirs):
    ref_dir, _ = dirs
    model = init_model(_cfg(), torch_device="cpu", trainable=True, seed=9)
    opt_cfg = adamw.AdamWConfig(**OPT)
    step, state = train_mod.restore_state(CheckpointManager(ref_dir), model)
    assert step == CKPT_STEP and int(state.step) == CKPT_STEP
    assert state.step.dtype == torch.int32
    want = lm_params_from_reference(nest(ref, "ck/params/"), _cfg())
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    want_mu = lm_params_from_reference(nest(ref, "ck/mu/"), _cfg())
    for k in want_mu:
        assert torch.equal(state.mu[k], want_mu[k]), k
    pipe = _pipe()
    for i in range(CKPT_STEP, STEPS):
        state, _ = train_step(model, state, pipe.batch(i), opt_cfg)
    _params_close(model, ref, "p5/")


def test_port_checkpoint_restores_into_the_reference(ref):
    model, state = _port_state(1)
    assert int(ref["port_ck/step"]) == 1 == int(ref["port_ck/opt_step"])
    want = lm_params_from_reference(nest(ref, "port_ck/params/"), _cfg())
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    want_nu = lm_params_from_reference(nest(ref, "port_ck/nu/"), _cfg())
    for k in want_nu:
        assert torch.equal(state.nu[k], want_nu[k]), k


def _train(fail_rate, **kw):
    return train_mod.train(_cfg(), steps=12, batch=2, seq=16, ckpt_every=4,
                           fail_rate=fail_rate, torch_device="cpu",
                           log=lambda line: None, **kw)


def test_injected_failures_replay_bit_for_bit(tmp_path):
    """Fault seed 11 at rate 0.2 fails steps 2, 9 and 11 once each:
    step 2 before any checkpoint (back to the initial weights), 9 and 11
    from the step-8 checkpoint."""
    clean = _train(0.0)
    faulty = _train(0.2, ckpt_dir=str(tmp_path))
    stats = faulty["stats"]
    assert (stats.restarts, stats.replayed_steps) == (3, 2 + 1 + 3)
    assert clean["stats"].restarts == 0
    assert faulty["steps"] == [0, 1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 9, 10,
                               8, 9, 10, 11]
    for (k, p), q in zip(clean["model"].named_parameters(),
                         faulty["model"].parameters()):
        assert torch.equal(p, q), k
    for k in clean["opt_state"].mu:
        assert torch.equal(clean["opt_state"].mu[k],
                           faulty["opt_state"].mu[k]), k
        assert torch.equal(clean["opt_state"].nu[k],
                           faulty["opt_state"].nu[k]), k
    # every replayed step computes the fault-free run's loss again
    by_step = dict(zip(clean["steps"], clean["losses"]))
    assert all(loss == by_step[s]
               for s, loss in zip(faulty["steps"], faulty["losses"]))
    # train's own checkpoints, under the reference's tree keys
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 8, 12]


def test_cli_trains_on_cpu(capsys):
    rc = train_mod.main(["--device", "cpu", "--reduced", "--steps", "20",
                         "--batch", "2", "--seq", "32", "--fail-rate",
                         "0.12", "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[train] smollm-135m-smoke on cpu: 20 steps" in out
    assert "restarts=1 replayed=4" in out


def test_cli_needs_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--reduced", "--steps", "1"])


FAMILIES = ("deepseek-v2-236b", "llama4-maverick-400b-a17b", "rwkv6-3b",
            "recurrentgemma-9b")


@pytest.mark.parametrize("name", FAMILIES)
def test_cli_trains_each_family_on_cpu(name, capsys):
    rc = train_mod.main(["--arch", name, "--device", "cpu", "--steps", "20",
                         "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert rc == 0, out                      # 0 only if the loss fell
    assert f"[train] {name}-smoke on cpu: 20 steps" in out


@pytest.mark.parametrize("name", FAMILIES)
def test_each_family_replays_injected_failures_bit_for_bit(name, tmp_path):
    """The schedule of ``test_injected_failures_replay_bit_for_bit``
    (steps 2, 9 and 11 fail once each) on the other families."""
    cfg = get_config(name).reduced()

    def run(rate, **kw):
        return train_mod.train(cfg, steps=12, batch=2, seq=40, ckpt_every=4,
                               fail_rate=rate, torch_device="cpu",
                               log=lambda line: None, **kw)

    clean, faulty = run(0.0), run(0.2, ckpt_dir=str(tmp_path))
    assert (faulty["stats"].restarts, faulty["stats"].replayed_steps) == (
        3, 6)
    for (k, p), q in zip(clean["model"].named_parameters(),
                         faulty["model"].parameters()):
        assert torch.equal(p, q), k
    for moments in ("mu", "nu"):
        a, b = (getattr(r["opt_state"], moments) for r in (clean, faulty))
        assert all(torch.equal(a[k], b[k]) for k in a), moments
    by_step = dict(zip(clean["steps"], clean["losses"]))
    assert all(loss == by_step[s]
               for s, loss in zip(faulty["steps"], faulty["losses"]))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ("smollm-135m",) + FAMILIES)
def test_checkpoint_trees_share_no_memory(name):
    """``save_state``'s tree (``lm_params_to_reference``) holds arrays of
    its own, shaped as ``lm_reference_shapes`` (``restore_state``'s
    template) says; the optimizer state ``restore_state`` builds from
    such a tree shares no memory with it, since AdamW updates its moments
    in place."""
    cfg = get_config(name).reduced()
    model = init_model(cfg, torch_device="cpu", trainable=True)
    params = dict(model.named_parameters())
    tree = lm_params_to_reference(params)
    shapes = dict(_leaves(lm_reference_shapes(params)))
    arrays = dict(_leaves(tree))
    assert set(shapes) == set(arrays)
    for path, arr in arrays.items():
        assert shapes[path].device.type == "meta", path
        assert tuple(shapes[path].shape) == arr.shape, path
        assert arr.flags.owndata, path
        assert not any(np.shares_memory(arr, p.detach().numpy())
                       for p in params.values()), path
    state = adamw_state_from_reference(np.int32(3), tree, tree, cfg, "cpu")
    assert int(state.step) == 3
    for moments in (state.mu, state.nu):
        assert set(moments) == set(params)
        for k, t in moments.items():
            assert torch.equal(t, params[k].detach()), k
            assert not any(np.shares_memory(t.numpy(), arr)
                           for arr in arrays.values()), k
