"""Three-term roofline of a counted step, on the card's constants.

The counterpart of the JAX package's ``analysis/roofline.py``:

    compute term    = FLOPs      / peak FLOP/s for the cell's dtype
    memory term     = bytes      / HBM bytes/s
    collective term = coll bytes / (link bytes/s x links active)

each per device. The counts come from :mod:`repro_torch.analysis.counting`
(one ``TorchDispatchMode`` over the step, on ``meta``, the CPU or cuda)
where the JAX package reads XLA's ``cost_analysis`` and the HLO text. The
card's constants are a :class:`Hardware` record, so the same properties
hold for any device whose figures are passed in; :data:`H100` is the
card this port runs on.

The module also holds the hand-counted least times of a step
(:func:`lm_step_bound`, :func:`dense_serve_bound`,
:func:`moe_serve_bound`): the work a step needs, counted from the
model's weights and shapes, where the counted roofline reads the work
the eager step does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peak rates and memory."""
    name: str
    bf16_flops: float            # dense 16-bit tensor-core FLOP/s
    fp32_flops: float            # float32 FLOP/s outside the tensor cores
    hbm_bytes_per_s: float
    hbm_bytes: float             # device memory capacity
    link_bytes_per_s: float      # one link, one direction
    links_active: int            # links a collective phase drives at once

    def peak_flops(self, dtype: torch.dtype) -> float:
        """The peak for operands of ``dtype``: the 16-bit tensor-core
        rate for bfloat16 and float16, else the float32 rate (TF32
        off)."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.bf16_flops
        return self.fp32_flops


# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet
# (dense rates, no sparsity, at the 700 W power limit).
H100 = Hardware(
    name="NVIDIA H100 SXM 80GB",
    bf16_flops=989e12,           # data sheet: BF16 Tensor Core, dense
    fp32_flops=67e12,            # data sheet: FP32
    hbm_bytes_per_s=3.35e12,     # data sheet: GPU memory bandwidth
    hbm_bytes=80e9,              # data sheet: GPU memory
    link_bytes_per_s=25e9,       # H100 whitepaper: NVLink 4, 50 GB/s a
    links_active=18,             # link both ways; 18 links, 900 GB/s
)


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float               # per-device counted FLOPs
    bytes_hbm: float           # per-device counted bytes
    bytes_coll: float          # per-device collective bytes
    model_flops: float         # 6*N(active)*D useful FLOPs (global)
    hardware: Hardware
    peak_flops: float          # per device, for the cell's dtype

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / self.hardware.hbm_bytes_per_s

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / (self.hardware.link_bytes_per_s
                                  * self.hardware.links_active)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Roofline step-time lower bound (max of the three terms —
        perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every device — how much of the
        step's compute is useful (catches remat, masked attention chunks
        and dispatch overhead)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Model FLOPs utilization at the roofline bound: useful FLOPs /
        (chips x peak x step_time_lb)."""
        t = self.step_time_lb
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)


def model_flops_for(cfg, shape) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE) for training; forward-only
    (2*N*D) for prefill; per-token 2*N_active for decode."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def from_record(rec: Dict, cfg, shape, hardware: Hardware,
                peak_flops: float) -> Optional[Roofline]:
    """The roofline of a dry-run record of status ``ok``; ``chips`` is
    the record's own (the JAX package infers 256 or 512 from the mesh
    name)."""
    if rec.get("status") != "ok":
        return None
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"], flops=rec["flops"],
        bytes_hbm=rec["bytes_accessed"],
        bytes_coll=rec.get("collectives", {}).get("total", 0.0),
        model_flops=model_flops_for(cfg, shape), hardware=hardware,
        peak_flops=peak_flops)


def format_row(r: Roofline) -> str:
    return (f"{r.arch},{r.shape},{r.mesh},{r.t_compute:.3e},"
            f"{r.t_memory:.3e},{r.t_collective:.3e},{r.bottleneck},"
            f"{r.model_flops:.3e},{r.useful_flops_fraction:.3f},"
            f"{r.mfu_upper_bound:.3f}")


HEADER = ("arch,shape,mesh,t_compute_s,t_memory_s,t_collective_s,"
          "bottleneck,model_flops,useful_frac,mfu_bound")


# ---------------------------------------------------------------------------
# Hand-counted least times of a step (the work it needs, not the work the
# eager step does)
# ---------------------------------------------------------------------------


def _rate(model) -> float:
    return H100.peak_flops(model.embed.dtype)


def dense_serve_bound(cfg, model, batch: int, prompt_len: int) -> dict:
    """Least times of a dense serve cell, each the larger of its bytes
    over ``H100.hbm_bytes_per_s`` and its operations over the card's
    rate for the weights' dtype (``H100.peak_flops``: float32 with TF32
    off, or bfloat16). A decode step reads every weight and the
    prompt's KV cache once and does 2 operations a weight a sequence.
    The prefill reads every weight and writes the KV cache once; it does
    2 operations a layer weight a prompt token, the causal attention's
    two products (S (S + 1) / 2 positions a head) and the LM head for
    the last position of each sequence."""
    elt = model.embed.element_size()
    rate = _rate(model)
    n_params = sum(p.numel() for p in model.parameters())
    head = model.embed if cfg.tie_embeddings else model.lm_head
    layer_params = sum(p.numel() for p in model.layers.parameters())
    tokens = batch * prompt_len
    kv_bytes = (cfg.n_layers * 2 * tokens * cfg.n_kv_heads * cfg.d_head
                * elt)
    attn_ops = (cfg.n_layers * 2 * 2 * batch * cfg.n_heads * cfg.d_head
                * prompt_len * (prompt_len + 1) / 2)
    prefill_ops = 2 * layer_params * tokens + attn_ops \
        + 2 * head.numel() * batch
    out = {}
    for name, nbytes, ops in (
            ("decode", n_params * elt + kv_bytes, 2 * n_params * batch),
            ("prefill", n_params * elt + kv_bytes, prefill_ops)):
        by_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
        by_ops = ops / rate * 1e3
        out[f"{name}_bound_ms"] = max(by_bytes, by_ops)
        out[f"{name}_bound_by"] = "bytes" if by_bytes >= by_ops \
            else "operations"
        out[f"{name}_bytes"], out[f"{name}_ops"] = nbytes, ops
    out["ops_per_s"] = rate
    return out


def moe_serve_bound(cfg, model, batch: int, prompt_len: int,
                    routed: list) -> dict:
    """Least times of a MoE serve cell, each the larger of its bytes over
    ``H100.hbm_bytes_per_s`` and its operations over the card's rate for
    the weights' dtype. A decode step reads every weight but the embedding
    table (it gathers a row a sequence) and the routed experts, then the
    experts it routed to (``routed``: the distinct experts of each MoE
    layer, from a measured step) and the prompt's cache (the latent pair
    under MLA, K and V under GQA); it does 2 operations an active weight
    a sequence (everything but the embedding table and the routed
    experts, plus ``top_k`` experts a MoE layer). ``decode_bound_all_
    experts_ms`` reads every expert, as the JAX package's dispatch does.
    The prefill reads those weights and every expert and writes the
    cache; it does 2 operations an active weight a prompt token, the
    causal attention's two products and the LM head at the last
    position of each sequence."""
    from repro_torch.models.transformer import MoELayer, _moe_layers

    elt = model.embed.element_size()
    rate = _rate(model)

    def nbytes(ps):
        return sum(p.numel() * p.element_size() for p in ps)

    moes = [layer.moe for layer, _ in _moe_layers(model)
            if isinstance(layer, MoELayer)]
    experts = [w for m in moes for w in (m.w_gate, m.w_up, m.w_down)]
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    head = model.embed if cfg.tie_embeddings else model.lm_head
    table = 0 if cfg.tie_embeddings else model.embed.numel()
    n_params = sum(p.numel() for p in model.parameters())
    base_params = n_params - sum(w.numel() for w in experts) - table
    base_bytes = (nbytes(model.parameters()) - nbytes(experts)
                  - table * elt)
    active = base_params + len(moes) * cfg.top_k * per_expert
    layer_active = active - head.numel() - model.final_norm.numel()
    tokens = batch * prompt_len
    if cfg.use_mla:
        cache = cfg.n_layers * tokens * (cfg.kv_lora_rank
                                         + cfg.qk_rope_head_dim) * elt
        qk, pv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    else:
        cache = cfg.n_layers * 2 * tokens * cfg.n_kv_heads * cfg.d_head * elt
        qk = pv = cfg.d_head
    attn_ops = (cfg.n_layers * 2 * batch * cfg.n_heads * (qk + pv)
                * prompt_len * (prompt_len + 1) / 2)
    decode_ops = 2 * active * batch
    out = {}
    for name, nb, ops in (
            ("decode", base_bytes + batch * cfg.d_model * elt
             + sum(routed) * per_expert * elt + cache, decode_ops),
            ("decode_all_experts", base_bytes + batch * cfg.d_model * elt
             + nbytes(experts) + cache, decode_ops),
            ("prefill", base_bytes + tokens * cfg.d_model * elt
             + nbytes(experts) + cache,
             2 * layer_active * tokens + attn_ops + 2 * head.numel() * batch)):
        by_bytes = nb / H100.hbm_bytes_per_s * 1e3
        by_ops = ops / rate * 1e3
        key = "decode_bound_all_experts" if name == "decode_all_experts" \
            else f"{name}_bound"
        out[f"{key}_ms"] = max(by_bytes, by_ops)
        out[f"{key}_by"] = "bytes" if by_bytes >= by_ops else "operations"
        out[f"{name}_bytes"], out[f"{name}_ops"] = nb, ops
    out["ops_per_s"] = rate
    out["active_params_per_token"] = active
    return out


def attention_pairs(seq: int, causal: bool, window=None) -> float:
    """Query-key pairs a head scores over ``seq`` positions: S^2, or
    S (S + 1) / 2 when causal, each query seeing at most ``window``."""
    if not causal:
        return seq * seq
    if window is None or window >= seq:
        return seq * (seq + 1) / 2
    return window * (window + 1) / 2 + (seq - window) * window


def lm_step_bound(cfg, model, batch: int, seq: int, train: bool,
                  routed_pairs=None) -> dict:
    """Least time of one forward (``train=False``) or train step over
    ``batch`` x ``seq`` tokens, the larger of its bytes over
    ``H100.hbm_bytes_per_s`` and its operations over the card's rate for
    the weights' dtype (``H100.peak_flops``: float32 with TF32 off, or
    bfloat16).
    Operations: 2 a matrix weight a token forward and 4 more backward
    (every weight of rank 2 or more but the embedding, the element-wise
    ``mu``, ``u`` and ``conv_w``, and the experts; the LM head; the
    embedding gather does none); the experts 2 x 3 D F a routed (token,
    expert) pair (``routed_pairs`` of one forward summed over the MoE
    layers, or every token's top-k when None); the attention's two
    products over the pairs a head scores (causal, windowed or not), at
    MLA's key and value widths; and the recurrences, a forward of
    ``wkv6`` 5 D^2 + 5 D a row and step, of ``rglru`` 2 an element, all
    again twice that backward. The recomputation of remat is not work
    the step needs and is not counted. Bytes: every weight read once (a
    train step also reads its two moments and writes the three back) and
    the logits written once (forward; a train step writes none)."""
    from repro_torch.models.attention import GQA, MLA
    from repro_torch.models.moe import MoE
    from repro_torch.models.rglru import RGBlock
    from repro_torch.models.rwkv6 import HEAD_DIM, TimeMix

    elt = model.embed.element_size()
    rate = _rate(model)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    # not matrix products a token: the embedding (a gather), the head
    # (counted once), the experts (counted by routed pair below) and the
    # element-wise TimeMix mixes and bonus and RG-LRU convolution
    skip = {id(model.embed), id(head)}
    for m in model.modules():
        if isinstance(m, MoE):
            skip.update(map(id, (m.w_gate, m.w_up, m.w_down)))
        elif isinstance(m, TimeMix):
            skip.update(map(id, (m.mu, m.u)))
        elif isinstance(m, RGBlock):
            skip.add(id(m.conv_w))
    mm = head.numel() + sum(p.numel() for p in model.parameters()
                            if p.dim() >= 2 and id(p) not in skip)
    n = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    ops = 2 * mm * tokens
    if cfg.moe:
        if routed_pairs is None:
            routed_pairs = tokens * cfg.top_k * cfg.moe_layout()[0]
        ops += 2 * 3 * cfg.d_model * cfg.moe_d_ff * routed_pairs
    window = cfg.local_window if cfg.family == "hybrid" else None
    pairs = attention_pairs(seq, not cfg.encoder_only, window)
    for m in model.modules():
        if isinstance(m, GQA):
            ops += 2 * 2 * batch * cfg.n_heads * cfg.d_head * pairs
        elif isinstance(m, MLA):
            ops += 2 * batch * cfg.n_heads * pairs * (
                cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
        elif isinstance(m, TimeMix):
            ops += tokens * m.u.shape[0] * (5 * HEAD_DIM ** 2 + 5 * HEAD_DIM)
        elif isinstance(m, RGBlock):
            ops += 2 * tokens * m.lam.numel()
    ops *= 3 if train else 1
    nbytes = (6 * n * 4 if train else n * elt + tokens * cfg.vocab * elt)
    by_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    by_ops = ops / rate * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_ops=ops, bound_bytes=nbytes, ops_per_s=rate)
