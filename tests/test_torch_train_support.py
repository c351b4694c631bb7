"""Shared machinery of the family training tests (holds no tests itself):
``tests/test_torch_train_moe.py`` and ``tests/test_torch_train_recurrent.py``.

One reference subprocess a file runs, for each case, five steps of the
reference's ``jax.value_and_grad(loss_fn)`` (remat on) then
``adamw.apply_updates`` from its own initial weights, each package's
synthetic pipeline giving the same batches. It records the initial
weights, the first step's gradients, each step's loss, gradient norm and
learning rate, and the parameters after five steps. It also saves a
checkpoint after two steps and restores the port's checkpoint written
before it ran. The port runs the same steps from the reference's weights
(``lm_params_from_reference``).

Tolerances: a step's loss, gradient norm and learning rate within 1e-5
relative, and the first step's gradients within 1e-5 of each leaf's max
|value| (the port's per-layer leaf), as ``tests/test_torch_train.py``'s.
The parameters after five steps: each leaf within 1e-3 of its max, and
at most 0.1 % of each leaf's elements beyond 1e-5 of that max (the
per-leaf share of ``chip_smoke.py``'s ``train_parity``), but for the
leaves ``SHARE_EXCEPT`` names. Adam moves an element by about lr
whatever its gradient's size, so an element whose gradient lies at the
float32 summation noise moves differently in the two packages; the
dense family's 1e-5 of a leaf's max does not hold here. Measured on the
CPU (the same at 1 and 4 threads): step metrics at most 7.6e-6
relative, first gradients at most 8.2e-6 of a leaf's max (RWKV-6's
``u``, a sum over every step and channel); after five steps at most
4.1e-4 of a leaf's max (RWKV-6's ``cm.w_r``; 3.0e-4 in deepseek's dense
``w_gate``, 6.8e-5 in the hybrid, 5.3e-5 in llama4). The worst share of
a leaf beyond 1e-5: 0.049 % in deepseek (``embed``), 0.024 % in llama4
(``attn.wo``); in RWKV-6 1.0 % (``tm.lora_a``), 0.71 % (``tm.decay_b``),
0.59 % (``tm.decay_a``) and 0.39 % (``tm.lora_b``), its low-rank mixes,
every other leaf at most 0.049 % (``tm.w_v``); in the hybrid 4 of 64 elements
(``block.gate_a_b``), 2 of 64 (``block.gate_x_b``, ``block.conv_b``),
the RG-LRU's 64-wide biases at the reduced width, each within 1.8e-5 of
its max, every other leaf at most 0.012 % (``mlp.w_gate``). A checkpoint read by the
other package is equal to the bit.
"""
import dataclasses
import os

import numpy as np
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import train_step
from repro_torch.models.transformer import init_model, loss_fn
from repro_torch.optim import adamw

RTOL = 1e-5
PARAM_TOL, PARAM_SHARE = 1e-3, 1e-3    # the parameters after five steps
# the leaves (by name suffix) allowed a larger share than PARAM_SHARE
# beyond RTOL after five steps, each at twice what was measured or more
SHARE_EXCEPT = {"tm.lora_a": 2e-2, "tm.lora_b": 2e-2, "tm.decay_a": 2e-2,
                "tm.decay_b": 2e-2, "block.gate_a_b": 0.125,
                "block.gate_x_b": 0.125, "block.conv_b": 0.125}
STEPS, CKPT_STEP = 5, 2
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=STEPS)

# tag -> (arch, depth or None for the reduced config's, batch, seq)
CASES = {
    "deepseek": ("deepseek-v2-236b", None, 4, 32),
    "llama4": ("llama4-maverick-400b-a17b", None, 4, 32),
    "rwkv6": ("rwkv6-3b", None, 2, 48),
    # one group and the 2-layer tail; 80 tokens past the window of 32
    "hybrid": ("recurrentgemma-9b", 5, 2, 80),
}


def cfg_of(tag):
    arch, depth, _, _ = CASES[tag]
    cfg = get_config(arch).reduced()
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def pipe_of(tag):
    _, _, batch, seq = CASES[tag]
    return SyntheticTokenPipeline(DataConfig(cfg_of(tag).vocab, seq, batch),
                                  torch_device="cpu")


REF = FLAT + """
import dataclasses
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.data import DataConfig, SyntheticTokenPipeline
from repro.models.transformer import init_model, loss_fn
from repro.optim import adamw

opt = adamw.AdamWConfig(**OPT)
for tag, (arch, depth, batch, seq) in CASES.items():
    cfg = get_config(arch).reduced()
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params = init_model(jax.random.PRNGKey(0), cfg)
    out.update(flat(params, tag + "/p0/"))
    state = adamw.init(params, opt)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab, seq, batch))

    def step(params, state, batch, cfg=cfg):
        loss, grads = jax.value_and_grad(loss_fn)(params, cfg, batch,
                                                  remat=True)
        params, state, m = adamw.apply_updates(params, grads, state, opt)
        m["loss"] = loss
        return params, state, m, grads

    step = jax.jit(step)
    for i in range(STEPS):
        params, state, m, grads = step(params, state, pipe.batch(i))
        if i == 0:
            out.update(flat(grads, tag + "/g0/"))
        out[f"{tag}/loss{i}"], out[f"{tag}/gnorm{i}"], out[f"{tag}/lr{i}"] = (
            m["loss"], m["grad_norm"], m["lr"])
        if i + 1 == CKPT_STEP:
            tree = {"params": params, "opt_mu": state.mu, "opt_nu": state.nu,
                    "opt_step": state.step}
            CheckpointManager(os.path.join(REF_DIR, tag)).save(CKPT_STEP, tree)
            out.update(flat(tree["params"], tag + "/ck/params/"))
            out.update(flat(tree["opt_mu"], tag + "/ck/mu/"))
    out.update(flat(params, tag + "/p5/"))
    like = {"params": params, "opt_mu": state.mu, "opt_nu": state.nu,
            "opt_step": state.step}
    got_step, tree = CheckpointManager(os.path.join(PORT_DIR, tag)).restore(
        like)
    out[tag + "/port_ck/step"] = np.array(got_step)
    out[tag + "/port_ck/opt_step"] = tree["opt_step"]
    out.update(flat(tree["params"], tag + "/port_ck/params/"))
    out.update(flat(tree["opt_nu"], tag + "/port_ck/nu/"))
"""


def port_state(tag, steps):
    """A port model and optimizer state after ``steps`` steps from the
    port's own seed (the checkpoint the reference restores)."""
    model = init_model(cfg_of(tag), torch_device="cpu", trainable=True,
                       seed=3)
    opt_cfg = adamw.AdamWConfig(**OPT)
    state = adamw.init(dict(model.named_parameters()), opt_cfg)
    pipe = pipe_of(tag)
    for i in range(steps):
        state, _ = train_step(model, state, pipe.batch(i), opt_cfg)
    return model, state


def run_family_reference(tags, tmp_path_factory, extra_body="",
                         inputs=None):
    """The reference's run of the ``tags`` cases (module docstring) and
    ``extra_body``, after the port wrote its one-step checkpoint of each
    case. Returns (the reference's outputs, its checkpoint directory)."""
    ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
    port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    for tag in tags:
        model, state = port_state(tag, 1)
        train_mod.save_state(CheckpointManager(os.path.join(port_dir, tag)),
                             1, model, state)
    cases = {tag: CASES[tag] for tag in tags}
    consts = (f"import os\nOPT = {OPT!r}\nSTEPS, CKPT_STEP = {STEPS}, "
              f"{CKPT_STEP}\nCASES = {cases!r}\nREF_DIR = {ref_dir!r}\n"
              f"PORT_DIR = {port_dir!r}\n")
    out = run_reference(consts + REF + extra_body, inputs,
                        tmp_path_factory.mktemp("ref_train"))
    return out, ref_dir


def model_from(ref, tag, prefix):
    cfg = cfg_of(tag)
    model = init_model(cfg, torch_device="cpu", trainable=True)
    model.load_state_dict(lm_params_from_reference(
        nest(ref, f"{tag}/{prefix}"), cfg))
    return model


def close(got, want, what, rtol=RTOL):
    got = got.detach().float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


def params_close(got, ref, tag, prefix, stepped=False):
    """Each leaf within ``RTOL`` of its max, or after steps (``stepped``)
    by the rule of the module docstring."""
    want = lm_params_from_reference(nest(ref, f"{tag}/{prefix}"), cfg_of(tag))
    assert set(got) == set(want)
    for k in want:
        if not stepped:
            close(got[k], want[k], f"{tag} {prefix}{k}")
            continue
        close(got[k], want[k], f"{tag} {prefix}{k}", rtol=PARAM_TOL)
        diff = (got[k].detach() - want[k]).abs()
        share = float((diff > RTOL * want[k].abs().max()).float().mean())
        limit = next((v for s, v in SHARE_EXCEPT.items()
                      if k.endswith(s)), PARAM_SHARE)
        assert share <= limit, (
            f"{tag} {prefix}{k}: {share} of its elements beyond {RTOL}")


def check_five_steps(ref, tag):
    """Five port steps from the reference's weights: each step's metrics
    and the parameters after them against the reference's."""
    model = model_from(ref, tag, "p0/")
    opt_cfg = adamw.AdamWConfig(**OPT)
    state = adamw.init(dict(model.named_parameters()), opt_cfg)
    pipe = pipe_of(tag)
    for i in range(STEPS):
        state, m = train_step(model, state, pipe.batch(i), opt_cfg)
        for key, name in (("loss", "loss"), ("grad_norm", "gnorm"),
                          ("lr", "lr")):
            close(m[key], ref[f"{tag}/{name}{i}"], f"{tag} step {i} {key}")
    assert int(state.step) == STEPS
    params_close(dict(model.named_parameters()), ref, tag, "p5/", True)
    assert float(ref[f"{tag}/loss{STEPS - 1}"]) < float(ref[f"{tag}/loss0"])


def check_first_step_gradients(ref, tag):
    model = model_from(ref, tag, "p0/")
    params = dict(model.named_parameters())
    loss = loss_fn(model, pipe_of(tag).batch(0), remat=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    params_close(dict(zip(params, grads)), ref, tag, "g0/")


def check_decay_mask(ref, tag):
    """``adamw.reference_ndim`` of every port parameter is the rank of
    its leaf in the reference's tree, so the port decays exactly the
    leaves the reference decays (rank 2 or more)."""
    tree = nest(ref, f"{tag}/p0/")
    model = init_model(cfg_of(tag), torch_device="cpu")
    for name, p in model.named_parameters():
        first, *rest = name.split(".")
        node = tree[first]
        for part in rest[1:] if rest and rest[0].isdigit() else rest:
            node = node[part]
        assert adamw.reference_ndim(name, p) == np.asarray(node).ndim, name


def check_reference_checkpoint(ref, ref_dir, tag):
    """The reference's step-2 checkpoint restored by the port: equal to
    the bit; three more port steps end at the reference's five-step
    parameters."""
    cfg = cfg_of(tag)
    model = init_model(cfg, torch_device="cpu", trainable=True, seed=9)
    step, state = train_mod.restore_state(
        CheckpointManager(os.path.join(ref_dir, tag)), model)
    assert step == CKPT_STEP and int(state.step) == CKPT_STEP
    want = lm_params_from_reference(nest(ref, f"{tag}/ck/params/"), cfg)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    want_mu = lm_params_from_reference(nest(ref, f"{tag}/ck/mu/"), cfg)
    assert set(want_mu) == set(state.mu)
    for k in want_mu:
        assert torch.equal(state.mu[k], want_mu[k]), k
    opt_cfg = adamw.AdamWConfig(**OPT)
    pipe = pipe_of(tag)
    for i in range(CKPT_STEP, STEPS):
        state, _ = train_step(model, state, pipe.batch(i), opt_cfg)
    params_close(dict(model.named_parameters()), ref, tag, "p5/", True)


def check_port_checkpoint(ref, tag):
    """The port's one-step checkpoint as the reference restored it:
    parameters and second moments equal to the bit."""
    cfg = cfg_of(tag)
    model, state = port_state(tag, 1)
    assert int(ref[f"{tag}/port_ck/step"]) == 1
    assert int(ref[f"{tag}/port_ck/opt_step"]) == 1
    want = lm_params_from_reference(nest(ref, f"{tag}/port_ck/params/"), cfg)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    want_nu = lm_params_from_reference(nest(ref, f"{tag}/port_ck/nu/"), cfg)
    for k in want_nu:
        assert torch.equal(state.nu[k], want_nu[k]), k
