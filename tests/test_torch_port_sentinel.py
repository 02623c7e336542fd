"""The port's read-only perf-regression sentinel
(``bigdl_tpu_torch.obs.sentinel``) against ``bigdl_tpu.obs.sentinel``
on synthetic artifacts of every family, written to a temporary
directory: the same rows, baselines and verdicts; ``--smoke`` passes
there; the CLI exits 1 on a regressed fresh file.  The port's one
difference: history comes only from ``--root`` (the committed
``BENCH_*.json`` are TPU numbers), so without it nothing is checked.
No test reads the committed artifacts."""

import json
import os
import subprocess
import sys

import pytest

from bigdl_tpu.obs import sentinel as jsentinel
from bigdl_tpu_torch.obs import sentinel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARTIFACTS = {
    "BENCH_r01.json": {"metric": "resnet50_train_throughput",
                       "value": 1000.0},
    "BENCH_r02.json": {"n": 2, "rc": 0, "parsed": {
        "metric": "resnet50_train_throughput", "value": 1100.0}},
    "BENCH_r03.json": {"metric": "resnet50_train_throughput",
                       "value": 5000.0, "suspect": True},
    "BENCH_r04.json": {"metric": "resnet50_train_throughput",
                       "value": 9000.0, "error": "no device"},
    "BENCH_dispatch_r01.json": {"metric": "train_dispatch_overhead_reduction",
                                "value": 3.0},
    "BENCH_loader_r01.json": {"pipeline_img_per_sec": 500.0,
                              "loader_img_per_sec": 800.0},
    "SERVING_r01.json": {"throughput_rps": 100.0, "p50_ms": 5.0,
                         "p99_ms": 20.0, "avg_batch_size": 8.0,
                         "geometry": "8 clients"},
    "SERVING_r02.json": {"throughput_rps": 90.0, "p50_ms": 4.0,
                         "p99_ms": 18.0},
    "DECODE_r01.json": {"tokens_per_s": 1000.0, "tokens_per_s_user": 50.0,
                        "ttft_ms_p50": 30.0, "ttft_ms_p99": 90.0,
                        "inter_token_p99_ms": 5.0, "speedup_vs_static": 2.0,
                        "geometry": "16 slots"},
    "CLUSTER_r01.json": {"mttr_s": 12.0, "recovery_bytes": 1e9},
    "KERNELS_r01.json": {"kernels": {
        "flash": {"parity_ok": True, "speedup": 1.5,
                  "speedup_amortized": 1.7},
        "probe_tile": {"parity_ok": True, "speedup": 9.0},
        "broken": {"parity_ok": False, "speedup": 9.0}}},
    "MULTICHIP_LARGE_r01.json": {"modes": {"dp_resnet50_multislice": {
        "ici_collective_bytes_per_step": 2e8,
        "dcn_collective_bytes_per_step": 5e7}}},
    "MULTICHIP_GRADCOMM_r01.json": {
        "metric": "grad_bytes_reduction_vs_fp32", "value": 3.9,
        "grad_bytes_reduction_vs_fp32": 3.9,
        "grad_sync_ici_bytes_per_step": 1e8,
        "grad_sync_dcn_bytes_per_step": 2e7},
    "MULTICHIP_LAYOUT_r01.json": {
        "metric": "layout_param_bytes_reduction", "value": 4.0,
        "layout_modes": {
            "dp": {"param_bytes_per_chip": 1e8,
                   "per_axis_bytes_per_step": {"data": 2e8}},
            "fsdp_tp": {"param_bytes_per_chip": 2.5e7,
                        "per_axis_bytes_per_step": {"fsdp": 3e8, "tp": 1e7},
                        "tp_activation_bytes_per_step": 4e6}}},
    "SLO_r01.json": {"slo_alert_latency_s": 2.0, "slo_burn_peak": 14.0},
    "DECODE_POOL_r01.json": {"tokens_per_s": 800.0, "geometry": "pool 2"},
    "DECODE_CHAOS_r01.json": {"bench": "decode_chaos",
                              "recovery_ms_p99": 300.0,
                              "chaos_tokens_per_s": 600.0},
    "RECSYS_r01.json": {"bench": "recsys", "recsys_qps": 1000.0,
                        "recommend_p99_ms": 20.0,
                        "recall_candidates_per_s": 1e6},
    "DECODE_QUANT_r01.json": {"bench": "decode_quant",
                              "slots_per_chip_ratio": 2.0,
                              "quant_tokens_per_s": 900.0},
    "DECODE_SPEC_r01.json": {"bench": "decode_spec",
                             "spec_tokens_per_s_user": 80.0,
                             "accept_rate": 0.8},
}


@pytest.fixture
def root(tmp_path):
    for name, doc in ARTIFACTS.items():
        (tmp_path / name).write_text(json.dumps(doc))
    (tmp_path / "SERVING_r03.json").write_text("not json")
    return str(tmp_path)


def _rows(history):
    return {fam: [(r.value, r.direction, r.source) for r in rows]
            for fam, rows in history.items()}


def test_history_rows_and_baselines_equal_jax(root):
    history = sentinel.load_history(root)
    jhistory = jsentinel.load_history(root)
    assert _rows(history) == _rows(jhistory)
    assert len(history) >= 30
    for fam in history:
        b, jb = (sentinel.baseline_for(fam, history),
                 jsentinel.baseline_for(fam, jhistory))
        assert (b.value, b.source) == (jb.value, jb.source)
    assert sentinel.baseline_for("resnet50_train_throughput",
                                 history).value == 1100.0
    assert sentinel.baseline_for("serving_p99_ms", history).value == 18.0


@pytest.mark.parametrize("scale", [0.8, 0.95, 1.25])
def test_check_verdicts_equal_jax(root, scale):
    """Every artifact, its numbers scaled, checked against the history:
    the same verdicts (a 20% drop regresses the higher-better families,
    a 25% rise the lower-better ones, a 5% drop the rows already below
    their family's best)."""
    history = sentinel.load_history(root)
    jhistory = jsentinel.load_history(root)

    def scaled(doc):
        if isinstance(doc, dict):
            return {k: scaled(v) for k, v in doc.items()}
        if isinstance(doc, (int, float)) and not isinstance(doc, bool):
            return doc * scale
        return doc

    n_regressed = 0
    for name, doc in ARTIFACTS.items():
        fresh = scaled(doc)
        got = [v.asdict() for v in sentinel.check(fresh, history,
                                                  source=name)]
        want = [v.asdict() for v in jsentinel.check(fresh, jhistory,
                                                    source=name)]
        assert got == want, name
        n_regressed += sum(v["regressed"] for v in got)
    assert n_regressed > 0
    assert sentinel.check({"metric": "brand_new", "value": 1.0},
                          history) == []
    assert sentinel.normalize({"metric": "x", "value": 1.0,
                               "error": "e"}, "s") == []


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.obs.sentinel", *args],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_smoke_and_cli_gate(root, tmp_path_factory):
    proc = _cli("--smoke", "--root", root, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["smoke"] == "ok"
    assert verdict["families"] == len(sentinel.load_history(root))
    fresh_dir = tmp_path_factory.mktemp("fresh")
    bad = fresh_dir / "fresh.json"
    bad.write_text(json.dumps({"metric": "resnet50_train_throughput",
                               "value": 550.0}))
    proc = _cli(str(bad), "--root", root, cwd=str(fresh_dir))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["regressed"] is True and out["ratio"] == 0.5
    good = fresh_dir / "bench.log"
    good.write_text("a log line\n" + json.dumps(
        {"metric": "resnet50_train_throughput", "value": 1090.0}) + "\n")
    assert _cli(str(good), "--root", root, cwd=str(fresh_dir)) \
        .returncode == 0


def test_without_root_there_is_no_history(root):
    """Run from a directory full of artifacts (or the repo root with its
    committed TPU ones), the CLI without ``--root`` checks nothing."""
    assert sentinel.load_history(None) == {}
    bad = os.path.join(root, "fresh.json")
    with open(bad, "w") as f:
        json.dump({"metric": "resnet50_train_throughput", "value": 1.0}, f)
    proc = _cli(bad, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["checked"] == 0 and "no history" in out["note"]
    smoke = _cli("--smoke", cwd=root)
    assert smoke.returncode == 1
    assert "no history" in json.loads(
        smoke.stdout.strip().splitlines()[-1])["reason"]
