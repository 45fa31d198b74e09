"""Every configuration, traffic mix, cell and per-layer metric of
BENCHMARK.json loads by its name, and a new cell, configuration, mix
and metric are picked up from new files alone."""
import json
import re
import shutil

import pytest

from portbench import harness
from portbench.yardstick.trace import DeviceOp, Trace

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    c = harness.cell(w["name"])
    assert c.chips == w["chips"] == 1
    assert harness.driver(c).__name__.endswith(c.traffic["driver"])
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer and c.limits


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(m):
    assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert NAME.match(key)


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_added_by_files_alone(tmp_path):
    """A later PR adds a configuration, a mix, a cell and a metric as
    new files plus entries of BENCHMARK.json; the harness finds them
    without an edit of its own."""
    root = tmp_path / "portbench"
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(harness.HERE / d, root / d)
    cfg = json.loads((root / "configs" / "fd-64peers.json").read_text())
    cfg.update(name="fd-16peers")
    cfg["deployment"].update(peers=16)
    (root / "configs" / "fd-16peers.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "closed-stacked-64.json")
                     .read_text())
    mix.update(queries_per_call=16)
    (root / "traffic" / "closed-stacked-16.json").write_text(
        json.dumps(mix))
    (root / "cells" / "fd-query-16.json").write_text(
        json.dumps({"limits": {"wrong_answers": 0}}))
    (root / "metrics" / "ops_per_call.query.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx['trace'].ops) / ctx['counts']['calls']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "fd-16peers"})
    bench["workloads"].append({"name": "fd-query-16", "config": "fd-16peers",
                               "traffic": "closed-stacked-16", "chips": 1})
    for m in bench["end_to_end"]:
        if "workloads" in m and "fd-query-64" in m["workloads"]:
            m["workloads"].append("fd-query-16")
    bench["per_layer"].append({"name": "ops_per_call.query", "unit": "count",
                               "moves": "topk_queries_s",
                               "workloads": ["fd-query-16"]})
    c = harness.cell("fd-query-16", bench, root=root)
    assert c.config["deployment"]["peers"] == 16
    assert c.traffic["queries_per_call"] == 16
    assert [m["name"] for m in c.per_layer] == ["ops_per_call.query"]
    assert {m["name"] for m in c.end_to_end} == {
        "topk_queries_s", "query_p95_ms", "setup_s"}
    trace = Trace([DeviceOp("k", 0.0, 1.0)] * 6, 0.0, 10.0, [])
    read = harness.reader("ops_per_call.query", root=root)
    assert read({"trace": trace, "counts": {"calls": 3}}) == 2.0
