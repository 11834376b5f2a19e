"""The harness finds a configuration, a model family, a traffic mix, a
cell's limits and a per-layer metric by name, dropped in as new files, with
no edit."""

import json

import bench_util  # noqa: F401
from harness.specs import Specs


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("configs", "models", "workloads", "metrics", "limits"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "newmodel.json").write_text(json.dumps({"model": "newfamily", "multiple": 8}))
    (bench / "models" / "newfamily.py").write_text("def template():\n    return 'a module'\n")
    (bench / "workloads" / "newmix.json").write_text(json.dumps({"kind": "bulk_engine", "image_h": 10}))
    (bench / "limits" / "newmodel.newmix.json").write_text(json.dumps({"limits": {"rms_gap_levels": 1.5}}))
    (bench / "metrics" / "new_metric.cell.py").write_text("def read(data):\n    return data['x'] * 2\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "newmodel", "file": "bench/configs/newmodel.json"}],
        "workloads": [{"name": "newmodel.newmix", "config": "newmodel", "traffic": "newmix", "chips": 1},
                      {"name": "other", "config": "newmodel", "traffic": "newmix", "chips": 1}],
        "end_to_end": [{"name": "img_s", "unit": "img/s", "workloads": ["newmodel.newmix"]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "new_metric.cell", "unit": "%", "moves": "img_s"},
                      {"name": "listed", "unit": "%", "moves": "setup_s", "workloads": ["other"]}],
    }))
    specs = Specs(tmp_path, bench)
    cell = specs.workload("newmodel.newmix")
    assert specs.config(cell["config"]) == {"model": "newfamily", "multiple": 8}
    assert specs.family(specs.config(cell["config"])["model"]).template() == "a module"
    assert specs.traffic(cell["traffic"])["kind"] == "bulk_engine"
    assert specs.limits("newmodel.newmix") == {"rms_gap_levels": 1.5}
    assert specs.limits("other") == {}
    assert [m["name"] for m in specs.end_to_end("newmodel.newmix")] == ["img_s", "setup_s"]
    assert [m["name"] for m in specs.end_to_end("other")] == ["setup_s"]
    # a metric without "workloads" goes to every cell that reports what it moves
    assert [m["name"] for m in specs.per_layer("newmodel.newmix")] == ["new_metric.cell"]
    assert [m["name"] for m in specs.per_layer("other")] == ["listed"]
    assert specs.reader("new_metric.cell")({"x": 21}) == 42


def test_the_repository_benchmark_resolves():
    specs = Specs(bench_util.ROOT)
    doc = specs.doc
    for cell in doc["workloads"]:
        family = specs.family(specs.config(cell["config"])["model"])
        assert all(callable(getattr(family, f, None)) for f in ("template", "reference", "program"))
        if specs.traffic(cell["traffic"])["kind"] == "bulk_forward":
            assert callable(getattr(family, "forward", None))
        assert specs.traffic(cell["traffic"])["kind"]
        assert {m["name"] for m in specs.end_to_end(cell["name"])} >= {"setup_s"}
        assert len(specs.end_to_end(cell["name"])) >= 2
        assert specs.per_layer(cell["name"])
        for m in specs.per_layer(cell["name"]):
            assert callable(specs.reader(m["name"]))
