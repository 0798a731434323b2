"""The plain reference: a float32 forward of a decoder-only transformer in
plain PyTorch, written from the published description of the two
configurations the benchmark runs (a dense GQA stack, InternLM2; a
fine-grained MoE stack, DeepSeekMoE) and the serving port's stated
dispatch rule. It imports nothing of the port and takes nothing the port
made: only the configuration file, the weights and tokens the benchmark
made, and the prompt length. ``archs/internlm2.py`` and
``archs/deepseek.py`` name it; another architecture's reference may reuse
its ``Products``, ``rmsnorm``, ``rope``, ``attention`` and ``swiglu``.

Per layer: RMSNorm, attention (GQA, rotate-half rope over fp32 phases,
causal, softmax in fp32), residual; RMSNorm, a SwiGLU MLP ``silu(x @
w_gate) * (x @ w_in) @ w_out`` or a MoE, residual. Then the final
RMSNorm and the LM head over the published vocabulary.

The MoE: router probabilities are the softmax of ``x @ router``; each
token takes its ``num_experts_per_tok`` most probable experts (ties to
the lower index), weighted by their probabilities, divided by their sum
where ``norm_topk_prob``. Tokens are dispatched in groups: the prompt's
positions of the whole batch, row after row, in groups of
``min(group_size, B * S)``, and each scored step's B tokens as groups of
``min(group_size, B)``. In a group of ``g`` tokens an expert takes at most
``max(ceil(g * k / E * capacity_factor), k)`` choices, the first rank of
every token first, then the second, and so on, and within a rank in the
group's order; a choice past capacity adds nothing. The shared experts
are a SwiGLU of ``n_shared_experts * moe_intermediate_size`` every token
passes through.

The weights are the port's declared layout: ``embed`` (V', d), each
layer's ``norm1``/``norm2`` ``scale``, ``mixer`` ``w_q``, ``w_k``,
``w_v`` (d, heads * head_dim) and ``w_o``, ``mlp`` ``w_in``,
``w_gate``, ``w_out`` (for a MoE layer with a leading expert axis, plus
``router`` (d, E) and ``shared``), ``final_norm`` and ``lm_head`` (d, V').
V' may exceed the published vocabulary (padding): only the published
rows and columns are read.

Every matrix product goes through ``Products``: float32 with TF32 off,
or, for the control, each operand rounded to float8 e4m3 with a scale a
row (a column of the right operand) and the products summed in float32.
The forward runs layer by layer, each layer's weights cast on the way,
and the attention and the MLP in blocks of rows, so that it fits beside
the port's weights on one card.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0         # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 inside, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale along ``dim``'s other
    axes (the largest magnitude maps to 448), back in float32."""
    scale = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    """``mm(a, b)``: the float32 product of (..., m, k) and (..., k, n);
    ``precision="fp8"`` rounds a's rows and b's columns to float8 first."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, not "
                             f"{precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.precision == "fp8":
            a, b = _fp8(a, -1), _fp8(b, -2)
        return torch.matmul(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rope over positions 0.. of x (B, T, heads, hd)."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.outer(torch.arange(T, dtype=torch.float32,
                                   device=x.device), inv)       # (T, hd/2)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(pr: Products, q, k, v, q_block: int, scale: float = None):
    """Causal GQA attention. q and k (B, T, H | KH, hd), v (B, T, KH, dv),
    all float32 -> (B, T, H * dv). Query head h reads KV head h // (H /
    KH). ``scale``: the softmax's, hd ** -0.5 where None."""
    B, T, H, hd = q.shape
    KH, dv = k.shape[2], v.shape[-1]
    G = H // KH
    qg = q.reshape(B, T, KH, G, hd).permute(0, 2, 3, 1, 4)   # B,KH,G,T,hd
    kt = k.permute(0, 2, 3, 1)[:, :, None]                  # B,KH,1,hd,T
    vv = v.permute(0, 2, 1, 3)[:, :, None]                  # B,KH,1,T,dv
    out = torch.empty((B, KH, G, T, dv), dtype=torch.float32,
                      device=q.device)
    scale = hd ** -0.5 if scale is None else scale
    for i0 in range(0, T, q_block):
        i1 = min(T, i0 + q_block)
        s = pr.mm(qg[:, :, :, i0:i1], kt[..., :i1]) * scale  # ..., blk, i1
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(i1, device=q.device)[None, :]
        s.masked_fill_(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        out[:, :, :, i0:i1] = pr.mm(p, vv[:, :, :, :i1])
        del p
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H * dv)


def attend(pr: Products, q, pos, k, v, row_block: int = 32,
           scale: float = None):
    """Causal GQA attention of query rows at positions ``pos``: q (N, R,
    H, hd), pos (R,) int, k (N, T, KH, hd) and v (N, T, KH, dv) -> (N, R,
    H, dv) float32; row r reads keys 0 .. pos[r]. ``scale``: the
    softmax's, hd ** -0.5 where None."""
    N, R, H, hd = q.shape
    KH, dv = k.shape[2], v.shape[-1]
    G = H // KH
    scale = hd ** -0.5 if scale is None else scale
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]          # N,KH,1,hd,T
    vv = v.float().permute(0, 2, 1, 3)[:, :, None]          # N,KH,1,T,dv
    kpos = torch.arange(k.shape[1], device=q.device)
    out = torch.empty((N, R, H, dv), dtype=torch.float32, device=q.device)
    with exact_fp32():
        for r0 in range(0, R, row_block):
            r1 = min(R, r0 + row_block)
            qg = q[:, r0:r1].float().reshape(N, r1 - r0, KH, G, hd) \
                .permute(0, 2, 3, 1, 4)                       # N,KH,G,r,hd
            s = pr.mm(qg, kt) * scale                        # N,KH,G,r,T
            s.masked_fill_(kpos[None, :] > pos[r0:r1, None].long(),
                           float("-inf"))
            o = pr.mm(torch.softmax(s, dim=-1), vv)          # N,KH,G,r,dv
            out[:, r0:r1] = o.permute(0, 3, 1, 2, 4).reshape(N, r1 - r0, H,
                                                             dv)
    return out


def swiglu(pr: Products, x, w_in, w_gate, w_out, row_block: int):
    """(N, d) -> (N, d): silu(x @ w_gate) * (x @ w_in) @ w_out, in blocks
    of ``row_block`` rows."""
    w_in, w_gate, w_out = w_in.float(), w_gate.float(), w_out.float()
    out = torch.empty((x.shape[0], w_out.shape[1]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, x.shape[0], row_block):
        xb = x[r0:r0 + row_block]
        h = F.silu(pr.mm(xb, w_gate)) * pr.mm(xb, w_in)
        out[r0:r0 + row_block] = pr.mm(h, w_out)
    return out


def capacity(g: int, k: int, experts: int, factor: float) -> int:
    return max(math.ceil(g * k / experts * factor), k)


def slots(idx, experts: int, C: int):
    """Each choice's place in its expert's buffer, ``C`` where it is past
    capacity: rank-major, then the group's order. idx (g, k) -> (g, k)."""
    fill = torch.zeros(experts, dtype=torch.long, device=idx.device)
    out = torch.empty_like(idx)
    for r in range(idx.shape[1]):
        e = idx[:, r]
        hot = F.one_hot(e, experts)
        ahead = (torch.cumsum(hot, 0) - hot).gather(1, e[:, None])[:, 0]
        pos = fill[e] + ahead
        out[:, r] = torch.where(pos < C, pos, C)
        fill += hot.sum(0)
    return out


class Routing:
    """The MoE routes of one forward, in the serving port's call order
    (the prefill's MoE layers, then each step's): ``own``, the reference's
    own (top-k experts (G, g, k) in descending order, slots (G, g, k));
    ``forced``, routes to follow instead (another forward's, or the
    port's, whose router this then checks: ``gap`` is the largest share
    of its own k-th probability by which a followed choice falls short of
    it, a near tie where it is small; ``flips`` counts the tokens whose
    followed experts are not its own; ``bad_slots`` counts followed slots
    that the dispatch rule does not give for the followed experts)."""

    def __init__(self, forced=None):
        self.forced = forced
        self._own = {}
        self.gap = 0.0
        self.flips = 0
        self.bad_slots = 0

    @property
    def own(self):
        return [self._own[c] for c in sorted(self._own)]

    def take(self, call: int, probs, idx_own, slot_own, C: int):
        """Record call ``call``'s own routes; return the routes to
        follow."""
        self._own[call] = (idx_own, slot_own)
        if self.forced is None:
            return idx_own, slot_own
        idx, slot = (t.to(probs.device).long() for t in self.forced[call])
        G, g, k = idx.shape
        p = probs.reshape(G, g, -1)
        kth = p.gather(2, idx_own[..., k - 1:])[..., 0]
        least = p.gather(2, idx).amin(-1)
        short = (kth - least) / kth
        self.gap = max(self.gap, float(short.amax()))
        self.flips += int((short > 0).sum())
        want = torch.stack([slots(i, p.shape[-1], C) for i in idx])
        self.bad_slots += int((want != slot).sum())
        return idx, slot


def route(x, router, k: int, factor: float):
    """One group's own routing. x (g, d) float32 -> (probabilities (g,
    E), experts (g, k), slots (g, k), capacity)."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    C = capacity(x.shape[0], k, router.shape[1], factor)
    return probs, idx, slots(idx, router.shape[1], C), C


def calls(B: int, S: int, steps: int, group_size: int, device):
    """The serving port's MoE calls over the (B, S + steps) positions,
    flattened row-major: the prefill's, then each step's; each a list of
    its dispatch groups' row indices. The prefill groups the prompt's
    B * S tokens, row after row, by ``min(group_size, B * S)``; a step
    groups its B tokens by ``min(group_size, B)``."""
    T = S + steps
    rows = torch.arange(B * T, device=device).reshape(B, T)
    parts = [rows[:, :S].reshape(-1)] + [rows[:, S + t] for t in
                                         range(steps)]
    out = []
    for part in parts:
        gs = min(group_size, part.numel())
        if part.numel() % gs:
            raise ValueError(f"{part.numel()} tokens do not divide into "
                             f"groups of {gs}")
        out.append(list(part.split(gs)))
    return out


def moe(pr: Products, conf: dict, p: dict, x, layer_calls, first: int,
        every: int, routing: Routing, row_block: int):
    """(N, d) float32 -> (N, d): the routed experts over the layer's
    ``layer_calls`` (lists of groups) and the shared experts. The layer's
    c-th call is call ``first + c * every`` of the forward."""
    k = conf["num_experts_per_tok"]
    factor = conf["assumed"]["capacity_factor"]
    norm = bool(conf.get("norm_topk_prob", False))
    tok, exp, wt = [], [], []
    for c, groups in enumerate(layer_calls):
        own = [route(x[rows], p["router"], k, factor) for rows in groups]
        probs = torch.stack([o[0] for o in own])             # G, g, E
        C = own[0][3]
        idx, slot = routing.take(first + c * every, probs,
                                 torch.stack([o[1] for o in own]),
                                 torch.stack([o[2] for o in own]), C)
        w = probs.gather(2, idx)
        if norm:
            w = w / w.sum(-1, keepdim=True)
        rows = torch.stack(groups)[..., None].expand_as(idx)
        kept = slot < C
        tok.append(rows[kept])
        exp.append(idx[kept])
        wt.append(w[kept])
    tok, exp, wt = torch.cat(tok), torch.cat(exp), torch.cat(wt)
    out = torch.zeros_like(x)
    order = torch.argsort(exp, stable=True)
    tok, exp, wt = tok[order], exp[order], wt[order]
    counts = torch.bincount(exp, minlength=p["w_in"].shape[0]).tolist()
    start = 0
    for e, n in enumerate(counts):
        if n:
            sel = slice(start, start + n)
            y = swiglu(pr, x[tok[sel]], p["w_in"][e], p["w_gate"][e],
                       p["w_out"][e], row_block)
            out.index_add_(0, tok[sel], y * wt[sel, None])
        start += n
    if "shared" in p:
        s = p["shared"]
        out += swiglu(pr, x, s["w_in"], s["w_gate"], s["w_out"], row_block)
    return out


def layers(params):
    """The layers of the port's tree, in order."""
    for segment in params["segments"]:
        for unit in segment:
            for key in sorted(unit, key=int):
                yield unit[key]


@torch.no_grad()
def forward(conf: dict, params, tokens: torch.Tensor, prompt_len: int, *,
            precision: str = "fp32", routing: Routing = None,
            q_block: int = 512, row_block: int = 8192) -> torch.Tensor:
    """tokens (B, T) -> float32 logits (B, T - prompt_len + 1, V) at
    positions prompt_len - 1 .. T - 1 over the published vocabulary V:
    the prompt's last position and each fed token's. ``routing``: a MoE
    config's routes, recorded and, where it holds some, followed."""
    pr = Products(precision)
    routing = Routing() if routing is None else routing
    B, T = tokens.shape
    steps = T - prompt_len
    V, d = conf["vocab_size"], conf["hidden_size"]
    H = conf["num_attention_heads"]
    KH = conf.get("num_key_value_heads", H)
    hd = conf.get("head_dim") or d // H
    eps, theta = conf["rms_norm_eps"], float(conf["rope_theta"])
    moe_calls = (calls(B, prompt_len, steps, conf["assumed"]["group_size"],
                       tokens.device)
                 if "n_routed_experts" in conf else None)
    n_moe = sum("router" in lp["mlp"] for lp in layers(params))
    j = 0
    with exact_fp32():
        x = params["embed"][tokens.long()].float()           # (B, T, d)
        for lp in layers(params):
            a = lp["mixer"]
            h = rmsnorm(x, lp["norm1"]["scale"], eps)
            q = rope(pr.mm(h, a["w_q"]).view(B, T, H, hd), theta)
            k = rope(pr.mm(h, a["w_k"]).view(B, T, KH, hd), theta)
            v = pr.mm(h, a["w_v"]).view(B, T, KH, hd)
            del h
            o = attention(pr, q, k, v, q_block)
            del q, k, v
            x += pr.mm(o, a["w_o"])
            del o
            h = rmsnorm(x, lp["norm2"]["scale"], eps).view(B * T, d)
            m = lp["mlp"]
            if "router" in m:
                y = moe(pr, conf, m, h, moe_calls, j, n_moe, routing,
                        row_block)
                j += 1
            else:
                y = swiglu(pr, h, m["w_in"], m["w_gate"], m["w_out"],
                           row_block)
            del h
            x += y.view(B, T, d)
            del y
        h = rmsnorm(x[:, prompt_len - 1:], params["final_norm"]["scale"],
                    eps)
        return pr.mm(h, params["lm_head"][:, :V])
