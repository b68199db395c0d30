"""``chip_smoke.py`` on a machine without a GPU.

It must refuse to report a result (non-zero exit, nothing on stdout)
without a card or outside a checkout, and its ``--rehearse`` mode must
run every phase through the plain versions on the CPU.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_gpu_exits_without_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU exit is not "
                    "observable here")
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode == 2
    assert out.stdout == ""


def test_outside_a_checkout_exits_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_rehearsal_runs_every_phase_on_cpu():
    out = _run(["chip_smoke.py", "--rehearse"], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    for tag in ("[hash64] exact", "[probe] exact", "[agg_scatter] exact",
                "[mv_upsert] exact", "[agg_preagg] exact",
                "[mask_indices] exact", "[ring_append] exact",
                "[nexmark_bids] exact", "[hop_window] exact",
                "[nexmark_auctions] exact", "[nexmark_persons] exact",
                "[tag_insert_ranked] exact", "[tag_probe] exact",
                "[join_update] exact", "[join_emit] exact",
                "[join_clean] exact", "[shadow_digest] exact",
                "[dirty_gather] exact", "[permute_rows] exact",
                "[topn_pool] exact", "[topn_band] exact",
                "[topn_flush] exact", "[hash64] exact on",
                "[probe] exact on the MV's whole-row key",
                "[parity] q7", "[parity] q5", "[parity] q1", "[parity] q8",
                "[parity] q19", "[parity] q18",
                "[check] q7 MV equals numpy", "[check] q5 MV equals numpy",
                "[check] q1 ring rows equal numpy",
                "[check] q8 ring rows equal the numpy join",
                "[check] q19 MV equals numpy", "[check] q18 MV equals numpy",
                "[check] q19 TopN overflow 0", "[check] q18 TopN overflow 0",
                "[durable] q7", "[durable] q8", "[durable] q19",
                "[cold start] q7", "[cold start] q8", "[cold start] q19",
                "[over_window] exact on 16 calls of every kind",
                "[over_window] exact on q6_bid's state",
                "[topn_clean] exact", "[topn_pool] on the over-window's",
                "float rows (float64, float32, nullable float64",
                "[probe] exact on float64 edge keys",
                "[parity] q6_bid", "[parity] ow_bid",
                "[check] q6_bid MV equals numpy",
                "[check] ow_bid MV equals numpy",
                "[check] q6_bid overflow and inconsistency counters 0",
                "[check] ow_bid overflow and inconsistency counters 0",
                "[main] q6_bid clean",
                "[join_dense] exact (q101's flush",
                "[join_emit] exact over a dense build",
                "[join_emit] exact over a pool build with transitions",
                "[agg_spill] exact on both branches",
                "[join_dense] clean_below and rebuild exact",
                "[join_dense] exact on the edge cases",
                "[parity] q101", "[parity] q103", "[parity] q104",
                "[check] q101 MV equals numpy", "[check] q103 MV equals numpy",
                "[check] q104 MV equals numpy",
                "[check] q101 overflow, inconsistency and emit_overflow 0",
                "[agg_distinct] exact", "[table_sweep] exact",
                "[agg_preagg] exact with string keys",
                "[topn_pool] on the dynamic filter's left input",
                "[dyn_filter] exact", "[parity] q102",
                "[check] q102 overflow and inconsistency 0",
                "[check] q102 MV equals numpy",
                "[str_cmp] exact", "[str_case_map] exact",
                "[str_split_part] exact", "[to_char] exact",
                "[regexp_group] exact", "[parity] q22", "[parity] q10",
                "[parity] q21", "[check] q22 ring rows equal numpy",
                "[check] q10 ring rows equal numpy",
                "[check] q21 ring rows equal numpy",
                "[temporal_probe] exact", "[parity] q13, 6 barriers",
                "[parity] q13 LEFT JOIN with churn",
                "[check] q13 ring rows equal numpy",
                "[check] q13 churn ring rows equal numpy",
                "[check] q13 churn: the ring, the build table",
                "[durable] q13 churn", "[cold start] q13 churn",
                "[str_replace] exact", "[str_match] exact",
                "[str_window] exact", "[calendar] exact",
                "[parity] q14", "[parity] bid_strings", "[parity] avg_bid",
                "[check] q14 ring rows equal numpy",
                "[check] bid_strings ring rows equal numpy",
                "[check] avg_bid MV equals numpy",
                "[agg_minput] exact", "[minput_refresh] exact",
                "[agg_eowc] exact", "[eowc_sort] EowcSortExecutor",
                "[parity] q5_max", "[parity] q7_eowc",
                "[parity] person_states",
                "[check] q5_max MV equals numpy",
                "[check] q7_eowc ring equals numpy",
                "[check] person_states MV equals numpy",
                "one index_select over leaf",
                "[sink_ring] exact (every leaf kind across a ring wrap",
                "[append_only_dedup] K19b on the card equals a CPU copy",
                "[check] q1_sink ring rows and ops equal numpy q1",
                "[check] q5_cascade MV equals numpy",
                "[check] q5_cascade drops: DROP MATERIALIZED VIEW q5 "
                "refused",
                "[check] q5_cascade durable restarted MV equals numpy",
                "[cold start] q5_cascade durable",
                "[check] dedup_sink ring holds exactly the first bid",
                "[check] dedup_sink: the watermark's K4 sweep ran",
                "[main] q5_cascade T = ", "[main] dedup_sink deliver: ",
                "[partial_agg] [crc32] [exchange] exact on edge cases",
                "[partial_agg] exact on q5's 4 lanes",
                "[partial_agg] exact on q7's 4 lanes",
                "[crc32] exact on q5's partial rows",
                "[check] q5 sharded MV equals numpy",
                "[check] q7 sharded MV equals numpy",
                "[check] q5 sharded MV equals the port's linear run",
                "[check] q7 sharded MV equals the port's linear run",
                "[cold start] q5 sharded", "[cold start] q7 sharded",
                "[shadow_digest_lanes] exact", "[dirty_gather_lanes] exact",
                "[check] q8 sharded ring rows equal the numpy join",
                "[check] q8 sharded ring equals the port's linear run",
                "[durable] q8 sharded", "[cold start] q8 sharded",
                "[vnode_gate] exact", "[vnode_sweep] exact on the agg",
                "[vnode_sweep] exact on the join side",
                "[vnode_transplant] exact on the agg",
                "[vnode_transplant] exact on the join side",
                "[troublemaker] exact", "[parity] scale_agg 2 -> 3 -> 2",
                "[parity] scale_join 1 -> 2 -> 1",
                "[check] scale_agg union of the partitions equals numpy",
                "[check] scale_agg union equals the port's linear engine",
                "[check] scale_join union of the partitions equals numpy",
                "[check] scale_join union equals the port's linear engine",
                "[check] troublemaker path"):
        assert tag in out.stdout
    assert '"ok"' not in out.stdout
    line = next(x for x in out.stdout.splitlines()
                if x.startswith('{"kernels"'))
    names = {k["name"] for k in json.loads(line)["kernels"]}
    assert {"sink_ring", "append_only_dedup", "crc32", "exchange",
            "partial_agg", "shadow_digest_lanes", "dirty_gather_lanes",
            "vnode_gate", "vnode_sweep", "vnode_transplant",
            "troublemaker"} <= names


def test_sink_paths_are_wired():
    """The slice's four paths and their kernels (K22b, and K19b's K1, K3
    and K4 sweep) are in the script's tables; nothing runs."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from risingwave_tpu_torch import kernels

    assert chip_smoke.SINK_PATHS == ("q1_sink", "q5_cascade",
                                     "q5_cascade durable", "dedup_sink")
    for path in chip_smoke.SINK_PATHS:
        assert "sink_ring" in chip_smoke.SINK_PATH_KERNELS[path]
        assert set(chip_smoke.SINK_PATH_KERNELS[path]) <= set(kernels.KERNELS)
    assert {"hash64", "probe", "table_sweep"} <= set(
        chip_smoke.SINK_PATH_KERNELS["dedup_sink"])
    assert kernels.KERNELS["sink_ring"] == "sink_ring"
    assert kernels.SOURCES["sink_ring"] == "sink_ring.cu"


def test_sharded_paths_are_wired():
    """The slice's four sharded paths run the exchange's kernels (K2, K24)
    and the partial aggregation (K22c); the durable ones K11 too."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from risingwave_tpu_torch import kernels

    assert chip_smoke.SHARD_PATHS == ("q5 sharded", "q7 sharded",
                                      "q5 sharded durable",
                                      "q7 sharded durable")
    for path in chip_smoke.SHARD_PATHS:
        kern = set(chip_smoke.SHARD_PATH_KERNELS[path])
        assert {"crc32", "exchange", "partial_agg"} <= kern
        assert kern <= set(kernels.KERNELS)
        assert ("shadow_digest" in kern) == path.endswith("durable")
    for name in ("crc32", "exchange", "partial_agg"):
        assert kernels.KERNELS[name] == name
        assert kernels.SOURCES[name] == f"{name}.cu"


def test_q8_sharded_paths_are_wired():
    """The slice's two q8 paths run the exchange's kernels (K2, K24) on
    q8's join path; the durable one K11 lanes, built from
    ``shadow_digest.cu``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from risingwave_tpu_torch import kernels

    assert chip_smoke.Q8_SHARD_PATHS == ("q8 sharded", "q8 sharded durable")
    for path in chip_smoke.Q8_SHARD_PATHS:
        kern = set(chip_smoke.Q8_SHARD_PATH_KERNELS[path])
        assert {"crc32", "exchange", "join_update", "join_emit"} <= kern
        assert kern <= set(kernels.KERNELS)
        assert ("shadow_digest_lanes" in kern) == path.endswith("durable")
    for name in ("shadow_digest_lanes", "dirty_gather_lanes"):
        assert kernels.KERNELS[name] == "shadow_digest"


def test_scale_paths_are_wired():
    """The slice's paths: both scale paths launch K25-K27 (the gate, the
    sweep, the transplant), the troublemaker path K28, each built from
    its own source."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from risingwave_tpu_torch import kernels

    assert chip_smoke.SCALE_PATHS == ("scale_agg", "scale_join",
                                      "troublemaker")
    for path in ("scale_agg", "scale_join"):
        kern = set(chip_smoke.SCALE_PATH_KERNELS[path])
        assert {"vnode_gate", "vnode_sweep", "vnode_transplant"} <= kern
        assert kern <= set(kernels.KERNELS)
    assert chip_smoke.SCALE_PATH_KERNELS["troublemaker"] == ("troublemaker",)
    for name in ("vnode_gate", "vnode_sweep", "vnode_transplant",
                 "troublemaker"):
        assert kernels.KERNELS[name] == name
        assert kernels.SOURCES[name] == f"{name}.cu"
