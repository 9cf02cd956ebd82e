"""Configurations, traffic, metrics and layer maps are found by name from
files of their own: a new one is new files, and no file is edited."""

import json
import shutil
from pathlib import Path

import pytest

from sdrbench import run, spec
from sdrbench.tests import small

REPO = small.ROOT.parent


def test_a_new_config_traffic_metric_and_layer_are_found(tmp_path):
    root = tmp_path / "bench"
    for kind in ("configs", "traffic"):
        (root / kind).mkdir(parents=True)
    shutil.copytree(small.ROOT / "layers", root / "layers")
    shutil.copytree(small.ROOT / "metrics", root / "metrics")
    cell = small.listener()
    cfg = dict(cell.config, name="throwaway_cfg")
    (root / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    (root / "traffic" / "throwaway_mix.json").write_text(
        json.dumps(cell.traffic))
    (root / "layers" / "throwaway_layer.json").write_text(json.dumps(
        {"layer": "throwaway layer", "kernels": ["no_such_kernel"]}))
    (root / "metrics" / "throwaway_metric.py").write_text(
        'UNIT = "ms"\nLAYER = "throwaway_layer"\nMOVES = "msps"\n\n\n'
        "def read(ctx):\n"
        "    assert ctx.device_s(LAYER) is None\n"
        "    return 1e3 * ctx.window_s / ctx.blocks\n")
    bench = {
        "configs": [{"name": "throwaway_cfg",
                     "file": str(root / "configs" / "throwaway_cfg.json")}],
        "workloads": [{"name": "throwaway_cell", "config": "throwaway_cfg",
                       "traffic": "throwaway_mix", "chips": 1}],
        "end_to_end": [{"name": "msps", "unit": "Msps"}],
        "per_layer": [{"name": "throwaway_metric", "unit": "ms",
                       "layer": "throwaway layer", "moves": "msps"},
                      {"name": "submit_ms", "unit": "ms", "layer": "entry",
                       "moves": "block_p95_ms",
                       "workloads": ["another_cell"]}],
    }
    found = spec.load_cell("throwaway_cell", bench, root=root, repo=root)
    assert found.config["name"] == "throwaway_cfg"
    assert [m["name"] for m in found.per_layer] == ["throwaway_metric"]
    assert spec.load_layers(root)["throwaway_layer"]["layer"] == \
        "throwaway layer"
    result, _ = run.run_cell(found, 3, 0.7, True, device="cpu", limits={},
                             root=root)
    assert set(result["metrics"]) == {"throwaway_metric"}
    assert result["metrics"]["throwaway_metric"]["value"] > 0


def test_the_benchmark_names_files_that_exist():
    bench = spec.load_benchmark(REPO)
    layers = spec.load_layers()
    for m in bench["per_layer"]:
        reader = spec.load_metric(m["name"])
        assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
        assert layers[reader.LAYER]["layer"] == m["layer"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench, repo=REPO)
        assert cell.traffic["name"] == w["traffic"]
        assert cell.config["name"] == w["config"]
        assert (small.ROOT / "limits" / f"{w['name']}.json").exists()
    for c in bench["configs"]:
        assert Path(REPO / c["file"]).exists()


def test_unknown_names_are_refused():
    bench = spec.load_benchmark(REPO)
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell", bench, repo=REPO)
    with pytest.raises(KeyError):
        spec.load_metric("no_such_metric")
