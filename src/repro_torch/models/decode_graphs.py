"""A decode step of the dense and MoE stacks, replayed from CUDA graphs.

Eagerly, Python launches each of a step's ~3,700-4,200 kernels (one per
op), and on the card the host, not the device, then sets the step's pace.
``Model.decode_step`` hands a step to ``DecodeGraphs`` where every layer
is a global ``attn`` mixer without cross-attention followed by a
``dense`` MLP or a ``moe`` layer and the token lies on a CUDA device;
every other stack, and every step on the CPU, runs eagerly as before.
The step then replays graphs captured once, cut where Python must see
the step:

- B6 (``ops.decode_attention_auto``, looked up at each call, so that a
  tape or a fault set over it runs) stays an eager call. Before it a
  layer replays one graph (norm1, q/k/v, rope, the in-place K/V write),
  after it one more (the o product and the residual), which reads B6's
  output copied into its input.
- The MoE's routes seam stays eager: one graph up to the router's own
  routes (norm2 with it); where ``model.routes`` is set, its ``route``
  gets a copy of them and what it returns is copied over them; then a
  graph for the combine weights, the dispatch and the experts, and one
  for the combine, the shared experts and the residual. A dense MLP
  layer is one graph.
- The token's embedding (with ``len + 1``, what B6 reads) and the final
  norm with the logits are a graph each.

Inputs are static: the token and ``cache["len"]`` are copied at the
step's start into buffers the graphs read; the logits come back as a
fresh tensor (a caller may keep every step's), and ``cache["len"]`` is
rebound to a new tensor, as eagerly. The graphs run the eager step's
ops, so the logits and the cache are bit for bit the eager step's.

A graph set is captured once over one set of inputs: the params and the
cache tensors (every leaf but ``len``, by identity, held weakly: the
graphs keep neither them nor the model alive) and the token's shape. The first step over a set runs eagerly on the stream the graphs
are captured on (the warm-up); the next step over the same set captures
the graphs, each into one memory pool shared by the set, and replays
them; later steps over it replay. A step over other tensors (a cloned
cache) runs eagerly and is never replayed. Once a tensor of the captured
set has been freed, the graphs go, and the next set is warmed up and
captured in its turn.

A replayed step keeps the spans that an eager step enters
(``common/spans.py``) around the replays of the pieces they hold, inside
a ``decode.graph`` span around the step's body: ``layer.mixer`` around
the two attention graphs and B6, ``layer.ffn`` around the MLP's graph or
the MoE's three; in it ``moe.route`` around the routing graph (which
holds norm2 too) and the seam, ``moe.dispatch`` around the weights, the
dispatch and the experts' products, ``moe.combine`` around the combine,
the shared experts and the residual. The graphs do not compute the MoE's
balance loss, which a decode step drops.

``COUNTS`` counts graph sets captured (``captures``), steps replayed
(``replayed_steps``) and steps of such a stack on a CUDA device that ran
eagerly (``eager_steps``); ``reset_counts`` zeroes them.
"""
from __future__ import annotations

import weakref
from typing import List

import torch

from repro_torch.common.spans import span
from repro_torch.kernels import launches
from repro_torch.models import transformer as tf
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers.mlp import mlp_apply
from repro_torch.models.layers.norms import apply_norm

COUNTS = {"captures": 0, "replayed_steps": 0, "eager_steps": 0}


def reset_counts() -> None:
    launches.reset(COUNTS)


def graphable(cfg) -> bool:
    """Every layer a global ``attn`` mixer without cross-attention,
    followed by a ``dense`` MLP or a ``moe`` layer."""
    return all(spec.mixer == "attn" and not spec.cross_attn
               and spec.mlp in ("dense", "moe")
               for seg in tf.build_segments(cfg) for spec in seg.unit)


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


class _Inputs:
    """A step's params and cache tensors, held weakly, and the token's
    shape."""

    def __init__(self, tensors, shape):
        self.refs = [weakref.ref(t) for t in tensors]
        self.shape = shape

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def same(self, tensors, shape) -> bool:
        return (shape == self.shape and len(tensors) == len(self.refs)
                and all(r() is t for r, t in zip(self.refs, tensors)))


class _Tape:
    """A step's pieces in order: each graph with what it returned, and
    each seam's value that a later graph reads. While ``capturing``, a
    graph is captured and then replayed (a capture runs nothing), and a
    seam's value is kept; after, a graph is replayed, and a seam's new
    value is copied into the kept tensor."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.items = []
        self.capturing = True
        self.at = 0

    def graph(self, fn):
        if self.capturing:
            g = torch.cuda.CUDAGraph()
            # other threads (replica lanes) may call CUDA meanwhile
            g.capture_begin(pool=self.pool,
                            capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                g.capture_end()
            self.items.append((g, out))
        g, out = self.items[self.at]
        self.at += 1
        g.replay()
        return out

    def hold(self, value: torch.Tensor) -> torch.Tensor:
        if self.capturing:
            self.items.append(value)
        kept = self.items[self.at]
        self.at += 1
        if kept is not value:
            kept.copy_(value)
        return kept


class DecodeGraphs:
    """The decode graphs of one ``Model``, which hands each of its steps
    on a CUDA device to ``step``. It holds no strong reference to the
    model, its params or its cache, so that dropping them frees them."""

    def __init__(self):
        self._inputs = None         # the set the graphs were captured over
        self._warm = None           # the set the last eager step warmed up
        self._tape = None
        self._stream = None

    def step(self, model, params, cache, token):
        tensors = _leaves(params, _leaves(
            [v for k, v in cache.items() if k != "len"], []))
        if self._inputs is not None and not self._inputs.alive():
            self._inputs = self._tape = None
        if self._inputs is not None and self._inputs.same(tensors,
                                                          token.shape):
            launches.bump(COUNTS, "replayed_steps")
            with span("decode.graph"):
                return self._run(model, params, cache, token)
        if self._inputs is None and self._warm is not None and \
                self._warm.same(tensors, token.shape):
            return self._capture(model, params, cache, token)
        launches.bump(COUNTS, "eager_steps")
        if self._inputs is not None:        # graphs over other tensors
            return model._decode_eager(params, cache, token)
        self._warm = _Inputs(tensors, token.shape)
        return self._on_side(
            lambda: model._decode_eager(params, cache, token))

    def _capture(self, model, params, cache, token):
        launches.bump(COUNTS, "captures")
        self._inputs, self._warm = self._warm, None
        self._tape = _Tape()
        self._token = torch.empty_like(token)
        self._len = torch.empty_like(cache["len"])
        with span("decode.graph"):
            out = self._on_side(
                lambda: self._run(model, params, cache, token))
        self._tape.capturing = False
        return out

    def _on_side(self, fn):
        """``fn`` on the capture stream, ordered after and before the
        current stream's work."""
        main = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(main.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = fn()
        main.wait_stream(self._stream)
        return out

    def _run(self, m, params, cache, token):
        """One step through the tape, capturing or replaying it."""
        cfg, tape = m.cfg, self._tape
        tape.at = 0
        cur_len = cache["len"]
        self._token.copy_(token)
        self._len.copy_(cur_len)
        x, valid = tape.graph(
            lambda: (m._embed(params, self._token), self._len + 1))
        positions = self._len.reshape(1, 1).expand(token.shape[0], 1)
        for si, seg in enumerate(tf.build_segments(cfg)):
            seg_cache = cache["segments"][si]
            for li, unit in enumerate(params["segments"][si]):
                for i, spec in enumerate(seg.unit):
                    x = self._layer(m, spec, unit[str(i)],
                                    seg_cache[str(i)], li, x, positions,
                                    valid)
        logits = tape.graph(lambda: m._logits(params, apply_norm(
            cfg.norm, params["final_norm"], x, cfg.norm_eps)[:, 0]))
        cache["len"] = cur_len + 1
        return logits.clone(), cache

    def _layer(self, m, spec, lp, lc, li, x, positions, valid):
        cfg, tape = m.cfg, self._tape
        eps = cfg.norm_eps

        def attn_in():
            h = apply_norm(cfg.norm, lp["norm1"], x, eps)
            q, k, v = tf._qkv(cfg, lp["mixer"], h, positions)
            tf._write_step(cfg, lc, li, k, v, self._len)
            return q

        with span("layer.mixer"):
            q = tape.graph(attn_in)
            o = tape.hold(tf._decode_attend(cfg, q, lc["k"][li],
                                            lc["v"][li], valid))
            x = tape.graph(lambda: x + tf._out_proj(lp["mixer"], o))
        with span("layer.ffn"):
            if spec.mlp == "dense":
                return tape.graph(lambda: x + mlp_apply(
                    lp["mlp"], apply_norm(cfg.norm, lp["norm2"], x, eps),
                    cfg.mlp))

            # the tape keeps tensors alone (a MoECall would hold the
            # experts' weights): each part makes its own over norm2's h
            def call(h):
                return moe_lib.MoECall(lp["mlp"], h, cfg.moe)

            def route():
                h = apply_norm(cfg.norm, lp["norm2"], x, eps)
                return (h, *call(h).route())

            with span("moe.route"):
                h, r, probs = tape.graph(route)
                self._seam(m, r)
            with span("moe.dispatch"):
                topv, (g, eout) = tape.graph(
                    lambda: (moe_lib.route_weights(probs, r),
                             call(h).experts(r)))
            with span("moe.combine"):
                return tape.graph(
                    lambda: x + call(h).mix(eout, r, topv, g))

    @staticmethod
    def _seam(m, r: moe_lib.Routes) -> None:
        """The routes seam: ``m.routes``, where set, gets a copy of the
        router's own routes, and what it returns goes over them."""
        if m.routes is None:
            return
        got = m.routes.route(moe_lib.Routes(r.topi.clone(),
                                            r.slot.clone()))
        r.topi.copy_(got.topi)
        r.slot.copy_(got.slot)
