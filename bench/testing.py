"""Helpers for the benchmark's CPU tests: toy configurations of the two
stacks at the widths the port's smoke configs use, a temporary copy of
the benchmark's layout with a toy cell added as files and entries, and a
toy architecture (``toy_mla/``) that such a copy takes as new files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOY_ARCH = ROOT / "bench" / "toy_mla"

# the widths of the port's internlm2-smoke and dsmoe-smoke
TOY_WIDTHS = {
    "internlm2-20b": dict(hidden_size=64, intermediate_size=128,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, vocab_size=256),
    "deepseek-moe-16b": dict(hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=4, vocab_size=256,
                             n_routed_experts=8, num_experts_per_tok=2,
                             moe_intermediate_size=32, n_shared_experts=1,
                             first_k_dense_replace=1),
}
TOY_GROUP = 64
# the accepted cell whose limits each toy configuration's runs are held to
TOY_LIMITS = {"internlm2-20b": "score_long.internlm2-20b",
              "deepseek-moe-16b": "score_docs.deepseek-moe-16b"}


def toy_config(name: str) -> dict:
    """A configuration file's contents at toy widths."""
    conf = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())
    conf.update(TOY_WIDTHS[name], name=f"toy-{name}")
    if "assumed" in conf and "group_size" in conf["assumed"]:
        conf["assumed"] = dict(conf["assumed"], group_size=TOY_GROUP)
    return conf


def toy_traffic(batch: int = 4, prompt_len: int = 32, steps: int = 3
                ) -> dict:
    return {"kind": "score_sweep", "batch": batch, "prompt_len": prompt_len,
            "scored_steps": steps, "in_flight": 1, "trace_batches": 2,
            "pool": {"n_domains": 3, "table": 16, "drift": 0.15},
            "why": "toy"}


def copy_layout(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` (its data files and readers)
    copied under ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def add_toy_cell(root: Path, config: str, *, traffic: dict = None,
                 limits_from: str = None, metric: str = None) -> str:
    """Add to the layout under ``root``, as new files and new entries
    only, a toy configuration of ``config``, a toy traffic mix, the limits
    of the real cell ``limits_from`` (else generous ones) and, with
    ``metric``, a per-layer metric of that name whose reader returns the
    number of batches. Returns the toy cell's name."""
    bench = root / "bench"
    limits = ({"limits": {"logits": 1.0, "scores": 1.0}} if limits_from is None
              else json.loads((bench / "limits" / f"{limits_from}.json")
                              .read_text()))
    cell = _add_cell(root, toy_config(config), traffic or toy_traffic(),
                     limits)
    if metric is not None:
        (bench / "metrics" / f"{metric}.py").write_text(
            "def read(ctx):\n    return len(ctx.batches)\n")
        spec = json.loads((root / "BENCHMARK.json").read_text())
        spec["per_layer"].append({"name": metric, "unit": "count",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "toy", "moves": "score_tokens_s"})
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


def add_toy_arch(root: Path) -> str:
    """Add to the layout under ``root``, as new files and new entries
    only, the toy MLA architecture of ``bench/toy_mla/`` (its arch module
    and its reference module under their ``model_type``, its
    configuration, its limits) and a toy cell of it. Returns the cell's
    name."""
    bench = root / "bench"
    shutil.copy(TOY_ARCH / "arch.py", bench / "archs" / "toy_mla.py")
    shutil.copy(TOY_ARCH / "reference.py", bench / "reference" / "toy_mla.py")
    return _add_cell(root, json.loads((TOY_ARCH / "config.json").read_text()),
                     toy_traffic(),
                     json.loads((TOY_ARCH / "limits.json").read_text()))


def _add_cell(root: Path, conf: dict, traffic: dict, limits: dict) -> str:
    bench = root / "bench"
    (bench / "configs" / f"{conf['name']}.json").write_text(
        json.dumps(conf))
    (bench / "traffic" / "toy_mix.json").write_text(json.dumps(traffic))
    cell = f"toy_mix.{conf['name']}"
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": conf["name"], "source": "toy",
                            "file": f"bench/configs/{conf['name']}.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": cell, "config": conf["name"],
                              "traffic": "toy_mix", "chips": 1,
                              "why": "toy"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell
