"""A configuration, a traffic mix and a metric dropped into their folders
are found by name, with no other edit."""

import json
import shutil

from perfbench import harness, netspec


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(f"{harness.HERE}/{kind}", tmp_path / kind)
    cfg = netspec.load_config("neuro3d")
    cfg["name"] = "neuro3d_narrow"
    for n in cfg["graph"]:
        if n["op"] == "conv" and n["name"] != "cls":
            n["n_f"] = 4
    (tmp_path / "configs" / "neuro3d_narrow.json").write_text(
        json.dumps(cfg))
    mix = harness.load_traffic("dense_request")
    mix.update(shape=[1, 6, 40, 40], volumes=1, warmup=1,
               check={"count": 1, "within": 1, "limit": 1e-4})
    (tmp_path / "traffic" / "tiny_request.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "requests_done.probe.py").write_text(
        "def read(w):\n    return float(w.requests)\n")
    bench = harness.load_bench()
    bench["configs"].append({"name": "neuro3d_narrow"})
    bench["workloads"].append({"name": "neuro3d_narrow.tiny_request",
                               "config": "neuro3d_narrow",
                               "traffic": "tiny_request", "chips": 1})
    bench["per_layer"].append({"name": "requests_done.probe", "unit": "1",
                               "moves": "dense_Mvox_s",
                               "workloads": ["neuro3d_narrow.tiny_request"]})
    bench["end_to_end"][0]["workloads"].append("neuro3d_narrow.tiny_request")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    monkeypatch.setattr(netspec, "HERE", str(tmp_path))
    r = harness.run_cell("neuro3d_narrow.tiny_request", 3, 0.5, 0,
                         device="cpu", bench=bench)
    assert r["correct"] and set(r["metrics"]) == {"dense_Mvox_s",
                                                   "setup_s"}
    r = harness.run_cell("neuro3d_narrow.tiny_request", 3, 0.5, 1,
                         device="cpu", bench=bench)
    assert r["metrics"]["requests_done.probe"]["value"] == r["attempted"]


def test_every_named_file_exists():
    bench = harness.load_bench()
    for c in bench["configs"]:
        assert netspec.load_config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        harness.load_traffic(w["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
