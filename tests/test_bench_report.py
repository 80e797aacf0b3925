"""bench.py survivability machinery (round-2 verdict item 1).

BENCH_r02 was rc=124/parsed=null because the old bench printed its single
JSON line only after ~7 serial stages. These tests pin the new contract
hermetically (no accelerator, no device work): the Reporter emits a full parseable
line at every tick, stage budgets skip-and-record instead of dying, the
roofline fields are present and sane, and the weights resolver records an
explicit fallback when offline.
"""

import json
import sys

sys.path.insert(0, "/root/repo")

import bench  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def _fake_results():
    return {
        "f32": {"qps": 15000.0, "p50_batch_ms": 2.1, "recall_at_10": 0.99,
                "query_batch": 32, "roofline": bench._roofline("f32", 32, 32 / 15000.0, kind=H100)},
        "int8q_q512": {"qps": 372000.0, "p50_batch_ms": 1.4,
                       "recall_at_10": 0.969, "query_batch": 512,
                       "roofline": bench._roofline("int8q_q512", 512,
                                                   512 / 372000.0, kind=H100)},
        "bad": {"qps": 9e9, "p50_batch_ms": 0.01, "recall_at_10": 0.5,
                "query_batch": 32, "roofline": {}},
    }


def test_reporter_emits_parseable_full_line(capsys):
    rep = bench.Reporter()
    rep.emit()  # pre-work emission: parseable even before any tier ran
    rep.set_headline(_fake_results())
    rep.doc["e2e"]["scale_10M"] = {"n": 1}
    rep.emit()
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]
    # Each emit prints the full doc THEN a compact driver line (r3 verdict
    # item 1: the full doc outgrew the driver's 2000-char tail buffer).
    assert len(lines) == 4
    first, full, last = (json.loads(lines[0]), json.loads(lines[-2]),
                         json.loads(lines[-1]))
    assert first["value"] == 0.0 and first["metric"]
    # Headline picks the fastest tier CLEARING the recall bar, not the
    # fastest overall ("bad" at 0.5 recall must lose).
    for doc in (full, last):
        assert doc["storage_tier"] == "int8q_q512"
        assert doc["value"] == 372000.0
        assert doc["vs_baseline"] == 37.2
    assert full["e2e"]["scale_10M"] == {"n": 1}
    # The LAST line is the one the driver keeps: it must survive the tail.
    assert len(lines[-1]) < 1500


def test_roofline_fields():
    r = bench._roofline("int8q_q512", 512, 512 / 372000.0, kind=H100)
    assert set(r) == {"achieved_tops", "hbm_gbps", "pct_peak_hbm",
                      "pct_peak_compute", "bound"}
    # 372k QPS at Q=512: per-batch 1.376ms over 1M rows x 388 B = 295 GB/s.
    assert 250 < r["hbm_gbps"] < 350
    assert 0 < r["pct_peak_hbm"] < 100
    assert r["bound"] in ("hbm", "compute")
    # int8 codes read half the bytes per row of bf16.
    r16 = bench._roofline("bf16", 32, 1e-3, kind=H100)
    r8 = bench._roofline("int8q", 32, 1e-3, kind=H100)
    assert r8["hbm_gbps"] < r16["hbm_gbps"]
    # A device without published peaks is an error, not a default.
    import pytest

    with pytest.raises(KeyError, match="no published peaks"):
        bench._roofline("int8q", 32, 1e-3, kind="cpu")


def test_reporter_recall_regression_still_emits():
    rep = bench.Reporter()
    rep.set_headline({"only": {"qps": 100.0, "p50_batch_ms": 1.0,
                               "recall_at_10": 0.2, "query_batch": 32}})
    assert rep.doc["storage_tier"] == "only"  # flagged, not a crash
    assert rep.doc["recall_at_10_vs_exact"] == 0.2


def test_resolve_weights_records_offline_fallback(monkeypatch, tmp_path):
    """Air-gapped host: the resolver must return 'random' WITH a reason,
    never silently (round-2 verdict item 2)."""
    import socket as socket_mod

    monkeypatch.setenv("MEMEX_MINILM_DIR", str(tmp_path / "nope"))

    def _no_net(*a, **kw):
        raise OSError("Name or service not known")

    monkeypatch.setattr(socket_mod, "create_connection", _no_net)
    arg, kind, reason = bench._resolve_weights()
    assert arg == "random" and kind == "random"
    assert reason and "offline" in reason


def test_resolve_weights_prefers_local_checkpoint(monkeypatch, tmp_path):
    mdir = tmp_path / "minilm"
    mdir.mkdir()
    for f in ("model.safetensors", "config.json", "vocab.txt"):
        (mdir / f).write_text("x")
    monkeypatch.setenv("MEMEX_MINILM_DIR", str(mdir))
    arg, kind, reason = bench._resolve_weights()
    assert arg == str(mdir) and kind == "real" and reason is None


def test_full_doc_sidecar_and_compact_telemetry(monkeypatch, tmp_path,
                                                capsys):
    """emit() persists the FULL doc to MEMEX_BENCH_DOC_PATH (the driver
    keeps only the compact tail line; the sidecar is the judge's complete
    evidence) and the compact line carries the r3-verdict telemetry:
    stream/batch ratio and encoder throughput/binding stage."""
    doc_path = tmp_path / "BENCH_FULL.json"
    monkeypatch.setenv("MEMEX_BENCH_DOC_PATH", str(doc_path))
    rep = bench.Reporter()
    rep.set_headline(_fake_results())
    rep.doc["e2e"]["llm_decode"] = {
        "stream_tok_per_s": 270.0, "batch_tok_per_s": 290.0,
        "first_token_ms": 120.5}
    rep.doc["e2e"]["ivf_prune_realtext"] = {
        "encode_windows_per_s": 2500.0,
        "encode_roofline": {"bound": "fetch", "pct_peak_mxu": 22.0}}
    rep.emit()
    lines = capsys.readouterr().out.strip().splitlines()
    compact = json.loads(lines[-1])
    assert compact["llm_stream_ratio"] == round(270.0 / 290.0, 3)
    assert compact["llm_first_token_ms"] == 120.5
    assert compact["encode_windows_per_s"] == 2500.0
    assert compact["encode_bound"] == "fetch"
    assert len(lines[-1]) < 1500
    sidecar = json.loads(doc_path.read_text())
    assert sidecar["storage_tier"] == "int8q_q512"
    assert sidecar["e2e"]["llm_decode"]["batch_tok_per_s"] == 290.0


def test_emit_without_doc_path_writes_nothing(monkeypatch, tmp_path,
                                              capsys):
    monkeypatch.delenv("MEMEX_BENCH_DOC_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    bench.Reporter().emit()
    capsys.readouterr()
    assert list(tmp_path.iterdir()) == []


def test_stage_budget_skips_recorded(monkeypatch, capsys):
    """A stage whose estimate exceeds the remaining budget is skipped and
    recorded — the driver artifact says WHAT is missing and why."""
    monkeypatch.setenv("MEMEX_BENCH_BUDGET_S", "0")
    rep = bench.Reporter()
    # Simulate main()'s scheduler on one stage without device work.
    import time as _t

    deadline = _t.monotonic()  # already expired
    est = 100
    remaining = deadline - _t.monotonic()
    assert remaining < est
    rep.doc["skipped_stages"].append(
        {"stage": "scale_10M", "why": f"budget ({remaining:.0f}s left, "
                                      f"needs ~{est}s)"})
    rep.emit()
    lines = capsys.readouterr().out.strip().splitlines()
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    assert full["skipped_stages"][0]["stage"] == "scale_10M"
    assert compact["skipped_stages"] == 1  # count in the compact line


def test_stage_error_surfaces_in_compact_line(capsys):
    """r4 verdict item 3: a crashed stage must be visible in the driver
    line, not only in the sidecar — the r4 record read all-green
    (`skipped_stages: 0`) while llm_decode had died with an *_error."""
    rep = bench.Reporter()
    rep.set_headline(_fake_results())

    def boom():
        raise RuntimeError("use-after-donate: buffer was donated")

    bench._stage_guard(rep.doc["e2e"], "llm_decode", boom)
    # nested stage-internal errors count too (e.g. ivf_int4_pruned_error
    # inside scale_10M)
    rep.doc["e2e"]["scale_10M"] = {
        "ivf_pruned": {"ivf_int4_pruned_error": "kernel lowering failed"}}
    c = rep.compact()
    assert c["errors"] == 2
    assert c["error_stages"] == ["ivf_int4_pruned", "llm_decode"]
    # protected from the fit-trimming loop: errors sit ahead of every
    # optional key
    keys = list(c.keys())
    assert keys.index("errors") < keys.index("skipped_stages")
    # and the guard recorded the message itself
    assert "use-after-donate" in rep.doc["e2e"]["llm_decode_error"]
