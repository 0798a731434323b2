"""The plain references against the port at toy widths on the CPU, both in
float32: the prefill's last logits and every scored step's through the
cache, the four scores, and the MoE's routes (capacity drops included);
each architecture's own reference (the toy MLA's beside the GQA and MoE
stacks')."""
import pytest
import torch

from bench import harness, testing, weights
from bench.reference import transformer as reference
from bench.reference.scores import KINDS, scores as plain_scores
from bench.traffic import Documents, ScoreSweep

B, S, STEPS = 4, 64, 3


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def _toy(tmp_path, config):
    """(layout, conf) of a toy configuration: the accepted stacks' from the
    repository's layout, the toy MLA from a copy that takes it as files."""
    if config == "toy-mla":
        root = testing.copy_layout(tmp_path)
        cell = testing.add_toy_arch(root)
        layout = harness.Layout(root)
        return layout, layout.config(layout.cell(cell)["config"])
    return harness.Layout(testing.ROOT), testing.toy_config(config)


def _port_run(layout, conf, seed, capacity_factor=None):
    """The port in float32 over one toy batch: (conf, weights, tokens,
    logits (B, 1 + STEPS, V), scores (4, STEPS, B), routes)."""
    from repro_torch.launch.serve import serve_steps
    from repro_torch.models.layers.moe import RouteTape
    from repro_torch.models.transformer import Model
    if capacity_factor is not None:
        conf["assumed"] = dict(conf["assumed"],
                               capacity_factor=capacity_factor)
    cfg = layout.arch(conf).port_config(conf)
    tape = RouteTape() if cfg.moe is not None else None
    model = Model(cfg, routes=tape)
    params = _f32(weights.make(model.param_decls(), conf["vocab_size"],
                               seed, "cpu"))
    t = ScoreSweep.from_file(testing.toy_traffic(B, S, STEPS))
    toks = Documents(t, conf["vocab_size"], seed).batch(0)
    prompts, fed = Documents.split(toks, STEPS)
    cache = model.init_cache(B, S + STEPS, "cpu", dtype=torch.float32)
    cache, logits = model.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, cache)
    rec = harness._Recording(model)
    scores, _ = serve_steps(rec, params, cache, logits, STEPS,
                            feed=torch.from_numpy(fed))
    port = torch.stack([logits] + rec.step_logits, 1)
    routes = None if tape is None else [(r.topi, r.slot)
                                        for r in tape.recorded]
    return conf, params, torch.from_numpy(toks), port, scores, routes


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("config", sorted(testing.TOY_WIDTHS) + ["toy-mla"])
def test_reference_matches_port_in_fp32(tmp_path, config, seed):
    layout, conf = _toy(tmp_path, config)
    conf, params, toks, port, scores, routes = _port_run(layout, conf, seed)
    own = layout.arch(conf).reference
    routing = own.Routing()
    ref = own.forward(conf, params, toks, S, routing=routing)
    assert ref.shape == (B, 1 + STEPS, conf["vocab_size"])
    assert (port[..., :ref.shape[-1]] - ref).abs().max() <= \
        2e-5 * ref.abs().max()
    plain = plain_scores(ref[:, 1:].reshape(-1, ref.shape[-1]))
    for i, k in enumerate(KINDS):
        assert torch.allclose(scores[i].T.reshape(-1).double(), plain[k],
                              rtol=1e-4, atol=1e-6), k
    if routes is not None:
        # the reference's own routes are the port's, call for call
        assert len(routing.own) == len(routes) == 1 + STEPS
        for (ri, rs), (pi, ps) in zip(routing.own, routes):
            assert torch.equal(ri, pi) and torch.equal(rs, ps)


def test_moe_capacity_drops_and_followed_routes():
    """At capacity factor 0.75 choices are dropped; the reference, handed
    the port's routes, reads no gap and no bad slot, and a planted wrong
    expert or slot shows."""
    conf, params, toks, port, _, routes = _port_run(
        harness.Layout(testing.ROOT), testing.toy_config("deepseek-moe-16b"),
        3, capacity_factor=0.75)
    C = reference.capacity(64, 2, 8, 0.75)
    assert any(bool((s == C).any()) for _, s in routes)
    routing = reference.Routing(forced=routes)
    ref = reference.forward(conf, params, toks, S, routing=routing)
    assert routing.gap == 0.0 and routing.bad_slots == 0
    assert (port[..., :ref.shape[-1]] - ref).abs().max() <= \
        2e-5 * ref.abs().max()
    wrong = [(i.clone(), s.clone()) for i, s in routes]
    wrong[0][0][0, 5] = wrong[0][0][0, 5].flip(0)     # swap one token's ranks
    routing = reference.Routing(forced=wrong)
    reference.forward(conf, params, toks, S, routing=routing)
    assert routing.bad_slots > 0 or routing.gap > 0


def test_slots_follow_rank_then_position():
    idx = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0]])
    # capacity 2: expert 0 takes tokens 0 and 1 at rank 0, drops token 2
    # at rank 0 and token 3 at rank 1; expert 1 takes token 3 (rank 0)
    # before tokens 0 and 2 (rank 1), so token 2's rank-1 choice drops
    assert reference.slots(idx, 3, 2).tolist() == [[0, 1], [1, 0], [2, 2],
                                                   [0, 2]]


def test_fp8_products_round_each_operand():
    pr = reference.Products("fp8")
    a = torch.randn(8, 32, generator=torch.Generator().manual_seed(0))
    b = torch.randn(32, 4, generator=torch.Generator().manual_seed(1))
    exact = a @ b
    low = pr.mm(a, b)
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
    assert torch.equal(reference.Products("fp32").mm(a, b), exact)
