"""Faults planted underneath a run's timed path, for showing that the check
that decides ``correct`` fails them: each ``plant(sweep)`` breaks the
``harness.Sweep`` (for the kernels, what its attention tape calls, so
that the tape sees the broken kernel's output) and returns a function
that undoes it.

- ``state_unchanged``: a decode step returns the cache it was given, its
  writes undone: the next step neither sees this step's token nor moves
  its position.
- ``half_batch_left_out``: the prefill and every step compute the first
  half of the batch twice over and leave the second half out.
- ``token_altered``: the second fed token of the first document is
  replaced by the next token id where the step takes it.
- ``answer_altered``: one score is altered where it is produced (the
  first document's second step's least confidence, p1 halved).
- ``flash_key_tile_dropped``: the prefill's attention kernel (B3) skips
  one tile of keys in the middle of the prompt and reads its neighbour in
  its place.
- ``decode_tail_dropped``: the decode attention kernel (B6) skips the
  last partial tile of keys (its length floored to a whole tile), the
  current token's own key with it.

For a MoE, ``wrong_expert`` and ``wrong_slot`` plant wrong choices in
routes the port recorded, for the reference to follow; the capacity and
the slot rule are those of the architecture's reference (``ref``).
"""
from __future__ import annotations

import torch

TILE = 128      # keys: the decode kernel's split and the flash kernel's tile


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _shell(tree):
    """``tree``'s containers copied, holding the same leaves."""
    if isinstance(tree, dict):
        return {k: _shell(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shell(v) for v in tree]
    return tree


def _rebind(tree, shell):
    """``tree``'s containers made to hold ``shell``'s entries again."""
    items = shell.items() if isinstance(shell, dict) else enumerate(shell)
    if isinstance(tree, dict):
        for k in set(tree) - set(shell):
            del tree[k]
    for k, v in items:
        if isinstance(v, (dict, list)):
            _rebind(tree[k], v)
        else:
            tree[k] = v


class _Wrap:
    """A model whose ``decode_step`` is ``step(real, params, cache,
    token)``."""

    def __init__(self, real, step):
        self.real, self.step = real, step

    def decode_step(self, params, cache, token):
        return self.step(self.real, params, cache, token)


def _wrap_steps(sweep, step):
    real = sweep.recording.model
    sweep.recording.model = _Wrap(real, step)

    def undo():
        sweep.recording.model = real
    return undo


def state_unchanged(sweep):
    # the cache is saved on the host, where a copy of it fits beside the
    # batch's, and written back after the step: its writes undone
    host = []

    def step(real, params, cache, token):
        shell, leaves = _shell(cache), _leaves(cache)
        if not host:
            host.extend(torch.empty(t.shape, dtype=t.dtype,
                                    pin_memory=t.is_cuda) for t in leaves)
        for h, t in zip(host, leaves):
            h.copy_(t)
        logits, _ = real.decode_step(params, cache, token)
        for h, t in zip(host, leaves):
            t.copy_(h)
        _rebind(cache, shell)
        return logits, cache
    return _wrap_steps(sweep, step)


def half_batch_left_out(sweep):
    real_prefill = sweep.model.prefill

    def first_half(t):
        h = t.shape[0] // 2
        return torch.cat([t[:h], t[:t.shape[0] - h]])

    def prefill(params, batch, cache):
        return real_prefill(params, {"tokens": first_half(batch["tokens"])},
                            cache)

    def step(real, params, cache, token):
        return real.decode_step(params, cache, first_half(token))
    sweep.model.prefill = prefill
    undo_steps = _wrap_steps(sweep, step)

    def undo():
        del sweep.model.prefill
        undo_steps()
    return undo


def token_altered(sweep):
    count = [0]
    vocab = sweep.conf["vocab_size"]

    def step(real, params, cache, token):
        count[0] += 1
        if count[0] % sweep.traffic.scored_steps == 2:
            token = token.clone()
            token[0] = (token[0] + 1) % vocab
        return real.decode_step(params, cache, token)
    return _wrap_steps(sweep, step)


def answer_altered(sweep):
    real = sweep.serve_steps

    def serve_steps(*args, **kw):
        scores, fed = real(*args, **kw)
        scores = scores.clone()
        scores[0, 1, 0] = 1.0 - (1.0 - scores[0, 1, 0]) / 2   # p1 halved
        return scores, fed
    sweep.serve_steps = serve_steps

    def undo():
        sweep.serve_steps = real
    return undo


def flash_key_tile_dropped(sweep):
    tape = sweep.tape
    real = tape.flash

    def flash(q, k, v, **kw):
        tile = min(TILE, k.shape[1] // 4)       # a toy prompt's quarter
        a = k.shape[1] // tile // 2 * tile
        k, v = k.clone(), v.clone()
        k[:, a:a + tile] = k[:, a - tile:a]
        v[:, a:a + tile] = v[:, a - tile:a]
        return real(q, k, v, **kw)
    tape.flash = flash

    def undo():
        tape.flash = real
    return undo


def decode_tail_dropped(sweep):
    tape = sweep.tape
    real = tape.decode

    def decode(q, k_cache, v_cache, cur_len, **kw):
        floored = cur_len // TILE * TILE
        floored = (floored.clamp_min(1) if torch.is_tensor(floored)
                   else max(floored, 1))
        return real(q, k_cache, v_cache, floored, **kw)
    tape.decode = decode

    def undo():
        tape.decode = real
    return undo


FAULTS = [state_unchanged, half_batch_left_out, token_altered,
          answer_altered, flash_key_tile_dropped, decode_tail_dropped]


def for_cell(traffic) -> list:
    """The faults a cell of this traffic can have: half of a batch of one
    is the batch."""
    return [f for f in FAULTS
            if traffic.batch > 1 or f is not half_batch_left_out]


def _planted_call(routes, steps: int) -> int:
    """The call a route fault goes into: the prefill's MoE call of the
    middle layer (the calls are the prefill's layers, then each step's)."""
    return len(routes) // (1 + steps) // 2


def wrong_expert(routes, steps: int, experts: int, capacity_factor: float,
                 ref):
    """``routes`` with one token in each dispatch group of the call moving
    its first choice to an expert it did not choose (half the experts
    along), the groups' slots then given by the dispatch rule, so only
    the choices are wrong. One token a group: a single wrong choice can
    land on a near tie, which no check that lets bfloat16's flips pass
    can tell from one."""
    out = [(i.clone(), s.clone()) for i, s in routes]
    idx, slot = out[_planted_call(routes, steps)]
    G, g, k = idx.shape
    C = ref.capacity(g, k, experts, capacity_factor)
    for grp in range(G):
        tok = g // 2
        chosen = set(idx[grp, tok].tolist())
        e = int(idx[grp, tok, 0])
        for step in range(experts // 2, experts + experts // 2):
            cand = (e + step) % experts
            if cand not in chosen:
                break
        idx[grp, tok, 0] = cand
        slot[grp] = ref.slots(idx[grp].long(), experts, C).to(slot.dtype)
    return out


def wrong_slot(routes, steps: int, experts: int, capacity_factor: float,
               ref):
    """``routes`` with the slots of two tokens that one expert took, in
    the same group and rank, exchanged: each choice in the other's place
    in the expert's buffer."""
    out = [(i.clone(), s.clone()) for i, s in routes]
    idx, slot = out[_planted_call(routes, steps)]
    g, k = idx.shape[1], idx.shape[2]
    C = ref.capacity(g, k, experts, capacity_factor)
    e0 = idx[0, :, 0]
    for e in e0.unique().tolist():
        rows = ((e0 == e) & (slot[0, :, 0] < C)).nonzero()[:, 0]
        if rows.numel() >= 2:
            a, b = int(rows[0]), int(rows[-1])
            slot[0, a, 0], slot[0, b, 0] = slot[0, b, 0].clone(), \
                slot[0, a, 0].clone()
            return out
    raise ValueError("no expert took two tokens at rank 0 in the group")
