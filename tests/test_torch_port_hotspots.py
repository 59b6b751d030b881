"""The port's hotspot windows (``attackfl_tpu_torch/profiler``) on the
CPU, against the JAX package's jax-free halves where they meet.

1. The miner on synthetic torch-format Chrome traces written here: kernel
   rows tied by correlation to their launches inside ``cpu_op`` and
   ``user_annotation`` spans, memcpy and memset rows, the profiler's
   ``Trace`` span ignored, nested self time, a CPU run's ``cpu_op`` rows,
   a CUDA run with no kernel row (``empty``), torn, empty and mixed
   directories.
2. ``op_category`` on aten, cuBLAS, cuDNN and CUTLASS names and on the
   port's kernels K1 (``train_epoch_kernel``) and K3 (``fill_masks``).
3. Golden reports on real traces from the card: one config-4 (cut) round
   under each backend, exported in a window by ``chip_smoke.py`` phase 16
   and compacted to the rows the miner reads, with their top ops,
   categories and books (``tests/data/torch_hotspots/``).
4. ``HotspotCapture``'s degrade cases (JAX ``tests/test_hotspots.py``):
   an unwritable profile directory, a profiler that raises at start (and
   one already active), an empty window, disabled telemetry.
5. End to end under ``run``, ``run_fast`` and the pipeline at
   ``test_torch_port_fused_rounds.py``'s size: one ``ok`` window each,
   valid by JAX's ``validate_event``; the params bit for bit with and
   without the window; JAX's ``hotspots_from_events`` and ``derive_record``
   give the port's block; ``hotspots show|diff`` exit as JAX's on the
   same directories; ``/hotspots`` and its gauge.
"""

import gzip
import json
import os
import urllib.request
from pathlib import Path

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.ledger.record import derive_record as jax_derive_record
from attackfl_tpu.profiler.cli import main as jax_hotspots_main
from attackfl_tpu.profiler.mine import hotspots_from_events as jax_hotspots_from_events
from attackfl_tpu.telemetry.events import validate_event as jax_validate_event
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import Config, TelemetryConfig
from attackfl_tpu_torch.ledger import record
from attackfl_tpu_torch.ledger.store import LedgerStore
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.profiler import capture as capture_mod
from attackfl_tpu_torch.profiler.capture import HotspotCapture
from attackfl_tpu_torch.profiler.mine import (
    hotspots_from_events, kernel_short_name, mine_profile_dir, mine_trace, op_category,
)
from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.training.engine import Simulator
from test_torch_port_fused_rounds import SMALL

DATA = Path(__file__).resolve().parent / "data" / "torch_hotspots"
JAX_CORPUS = Path(__file__).resolve().parent / "data" / "profile_corpus"


def _write(path: Path, rows: list) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": rows}, fh)
    return path


def _x(cat, name, ts, dur, pid=1, tid=1, **args) -> dict:
    row = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if args:
        row["args"] = args
    return row


def _cuda_trace() -> list:
    """One labelled round on the host thread (1, 1): an ``aten::mm``
    launching a cuBLAS kernel, K1 launched through ctypes outside any
    aten op, a memcpy and a memset; one kernel launched outside every
    label; the profiler's own span and a flow row."""
    return [
        _x("Trace", "PyTorch Profiler (0)", 0, 1000),
        {"ph": "s", "id": 7, "pid": 1, "tid": 1, "ts": 12, "cat": "ac2g", "name": "ac2g"},
        _x("user_annotation", "round_step", 10, 300),
        _x("cpu_op", "aten::linear", 11, 40),
        _x("cpu_op", "aten::mm", 12, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 5, correlation=2),
        _x("cpu_op", "aten::copy_", 80, 20),
        _x("cuda_runtime", "cudaMemcpyAsync", 82, 5, correlation=3),
        _x("cuda_driver", "cuMemsetD32Async", 120, 4, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 500, 5, correlation=5),
        _x("kernel", "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32_cublas",
           100, 50, pid=0, tid=7, correlation=1),
        _x("kernel", "void train_epoch_kernel<128>(Groups, float const*, float*)",
           150, 400, pid=0, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 560, 10, pid=0, tid=7,
           correlation=3),
        _x("gpu_memset", "Memset (Device)", 580, 5, pid=0, tid=7, correlation=4),
        _x("kernel", "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)",
           600, 20, pid=0, tid=7, correlation=5),
    ]


def test_kernel_rows_take_their_launchs_label_and_aten_op(tmp_path):
    report = mine_trace(str(_write(tmp_path / "w.cuda.trace.json.gz", _cuda_trace())))
    assert report["status"] == "ok" and report["device"] == "cuda"
    rows = {r["name"]: r for r in report["ops"]}
    # the cuBLAS kernel is its launch's innermost aten op, K1 its short name
    assert rows["aten::mm"]["program"] == "round_step"
    assert rows["aten::mm"]["category"] == "matmul"
    assert rows["train_epoch_kernel"]["program"] == "round_step"
    assert rows["train_epoch_kernel"]["self_us"] == 400.0
    assert rows["aten::copy_"]["category"] == "copy"
    assert rows["Memset (Device)"]["category"] == "copy"
    # launched outside every label: no program, as in JAX
    assert rows["at::native::reduce_kernel"]["program"] == "<unknown>"
    assert rows["at::native::reduce_kernel"]["category"] == "reduction"
    # the host rows and the profiler's span are no device rows
    assert sum(r["count"] for r in report["ops"]) == 5
    assert report["lanes"] == 1
    books = report["books"]
    assert books["op_self_us"] == 485.0 and books["close"]
    # device busy 485 us over a 520 us span: the gaps are host time
    assert report["wall_us"] == 520.0 and report["device_busy_us"] == 485.0
    assert report["host_bound_fraction"] == round(35.0 / 520.0, 4)


def test_a_worker_threads_launch_takes_the_waiting_threads_label(tmp_path):
    """Autograd runs a backward pass on the card on a worker thread of
    its own while the labelled thread waits: its launches take the label
    that encloses them in time, their op the worker's own aten op."""
    rows = [
        _x("user_annotation", "round_step", 10, 300),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 40, 50, tid=2),
        _x("cpu_op", "aten::mm", 45, 30, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 5, tid=2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 5, tid=2, correlation=2),
        _x("kernel", "ampere_sgemm_128x64_tn", 100, 50, pid=0, tid=7, correlation=1),
        _x("kernel", "ampere_sgemm_128x64_nn", 410, 50, pid=0, tid=7, correlation=2),
    ]
    report = mine_trace(str(_write(tmp_path / "w.cuda.trace.json.gz", rows)))
    got = sorted((r["name"], r["program"]) for r in report["ops"])
    assert got == [("ampere_sgemm_128x64_nn", "<unknown>"), ("aten::mm", "round_step")]


def test_a_cuda_run_without_kernel_rows_mines_empty(tmp_path):
    """Host rows never stand in for the card: a CUDA window holding only
    CPU rows is ``empty``, and the same rows mined as a CPU run are its
    device rows."""
    rows = [r for r in _cuda_trace() if r.get("cat") not in ("kernel", "gpu_memcpy",
                                                            "gpu_memset")]
    cuda = mine_trace(str(_write(tmp_path / "w.cuda.trace.json.gz", rows)))
    assert cuda["status"] == "empty" and cuda["ops"] == []
    cpu = mine_trace(str(_write(tmp_path / "w.cpu.trace.json.gz", rows)))
    assert cpu["status"] == "ok" and cpu["device"] == "cpu"
    # the device argument wins over the name
    assert mine_trace(str(tmp_path / "w.cpu.trace.json.gz"), device="cuda")["status"] == "empty"


def test_a_cpu_run_mines_its_aten_ops_with_nested_self_time(tmp_path):
    rows = [
        _x("Trace", "PyTorch Profiler (0)", 0, 1000),
        _x("user_annotation", "aggregate", 0, 200),
        _x("cpu_op", "aten::linear", 10, 100),
        _x("cpu_op", "aten::t", 12, 4),
        _x("cpu_op", "aten::addmm", 20, 80),
        _x("cpu_op", "aten::copy_", 30, 10),
        _x("cpu_op", "aten::tanh", 300, 50),
    ]
    report = mine_trace(str(_write(tmp_path / "w.cpu.trace.json.gz", rows)))
    got = {r["name"]: (r["self_us"], r["program"], r["category"]) for r in report["ops"]}
    assert got == {"aten::linear": (16.0, "aggregate", "matmul"),
                   "aten::t": (4.0, "aggregate", "other"),
                   "aten::addmm": (70.0, "aggregate", "matmul"),
                   "aten::copy_": (10.0, "aggregate", "copy"),
                   "aten::tanh": (50.0, "<unknown>", "elementwise")}
    # self times add up to the busy union, which the wall bounds
    assert report["op_self_us"] == report["device_busy_us"] == 150.0
    assert report["books"]["close"]


def test_torn_empty_and_mixed_directories(tmp_path):
    good = _write(tmp_path / "mixed" / "a.cuda.trace.json.gz", _cuda_trace())
    torn = tmp_path / "mixed" / "b.cuda.trace.json.gz"
    torn.write_bytes(good.read_bytes()[:40])
    _write(tmp_path / "mixed" / "c.cuda.trace.json.gz", [])
    report = mine_profile_dir(str(tmp_path / "mixed"))
    assert (report["traces"], report["ok"], report["torn"], report["empty"]) == (3, 1, 1, 1)
    assert report["status"] == "ok" and report["books"]["close"]
    assert {w["status"] for w in report["windows"]} == {"ok", "torn", "empty"}
    (tmp_path / "none").mkdir()
    assert mine_profile_dir(str(tmp_path / "none"))["status"] == "no_traces"
    only_torn = tmp_path / "torn" / "b.cuda.trace.json.gz"
    only_torn.parent.mkdir()
    only_torn.write_bytes(good.read_bytes()[:40])
    assert mine_profile_dir(str(tmp_path / "torn"))["status"] == "torn"
    assert mine_trace(str(only_torn))["status"] == "torn"


@pytest.mark.parametrize("name,category", [
    ("aten::mm", "matmul"), ("aten::addmm", "matmul"), ("aten::bmm", "matmul"),
    ("aten::baddbmm", "matmul"), ("aten::linear", "matmul"),
    ("aten::convolution", "matmul"), ("aten::cudnn_convolution", "matmul"),
    ("ampere_sgemm_128x64_tn", "matmul"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_warpgroupsize1x1x1", "matmul"),
    ("cutlass::Kernel2", "matmul"), ("cudnn::cnn::conv2d_grouped_direct_kernel", "matmul"),
    ("wgmma_f32_kernel", "matmul"),
    ("aten::sum", "reduction"), ("aten::mean", "reduction"), ("aten::norm", "reduction"),
    ("aten::amax", "reduction"), ("aten::cumsum", "reduction"), ("aten::sort", "reduction"),
    ("aten::topk", "reduction"), ("aten::_softmax", "reduction"),
    ("aten::native_layer_norm", "reduction"), ("aten::std", "reduction"),
    ("aten::mul", "elementwise"), ("aten::add_", "elementwise"), ("aten::where", "elementwise"),
    ("aten::gelu", "elementwise"), ("at::native::vectorized_elementwise_kernel", "elementwise"),
    ("aten::copy_", "copy"), ("aten::cat", "copy"), ("aten::index", "copy"),
    ("aten::index_select", "copy"), ("aten::gather", "copy"), ("aten::scatter", "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"), ("Memset (Device)", "copy"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    (kernel_short_name("void train_epoch_kernel(Groups, float const*, float*)"), "matmul"),
    (kernel_short_name("fill_masks(long const*, float*, unsigned int, MaskDescriptor)"), "copy"),
    # JAX's HLO names keep their categories
    ("dot.4", "matmul"), ("all-reduce.1", "collective"), ("fusion.12", "other"),
])
def test_op_category_of_torch_and_cuda_names(name, category):
    assert op_category(name) == category


def test_kernel_short_names():
    assert kernel_short_name("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
                             "float, at::native::MeanOps<float>>>(at::native::ReduceOp<float>)"
                             ) == "at::native::reduce_kernel"
    assert kernel_short_name("train_epoch_kernel") == "train_epoch_kernel"
    assert kernel_short_name("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>"
                             "(cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)"
                             ) == "cutlass::Kernel2"


GOLDEN = ("config4_pallas_round.cuda.trace.json.gz", "config4_xla_round.cuda.trace.json.gz")


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_reports_on_traces_from_the_card(name):
    """Real windows from the card (``chip_smoke.py --fixtures``): the
    miner reproduces the top ops, categories, books and programs recorded
    beside them, and the port's kernel sits where it ran."""
    with open(DATA / "golden.json") as fh:
        golden = json.load(fh)[name]
    report = mine_trace(str(DATA / name))
    assert report["status"] == "ok" and report["books"]["close"]
    for key in ("top_ops", "categories", "books", "host_bound_fraction", "programs"):
        assert report[key] == golden[key], key
    kernel, label = (("train_epoch_kernel", "round_step") if "pallas" in name
                     else ("fill_masks", "round_step"))
    rows = [r for r in report["ops"] if r["name"] == kernel]
    assert rows and {r["program"] for r in rows} == {label}
    assert {r["category"] for r in rows} == {op_category(kernel)}
    assert os.path.getsize(DATA / name) <= 256 * 1024


class _Sink:
    def __init__(self):
        self.rows = []

    def emit(self, kind, **fields):
        self.rows.append({"kind": kind, **fields})


class _Tele:
    def __init__(self, base, enabled=True):
        self.events = _Sink()
        self.counters = Counters()
        self.enabled = enabled
        self.base_dir = str(base)

    def hotspots(self):
        return [e for e in self.events.rows if e["kind"] == "hotspot"]


def test_capture_degrades_on_unwritable_profile_dir(tmp_path, capsys):
    (tmp_path / "profile").write_text("not a directory")
    tele = _Tele(tmp_path)
    capture = HotspotCapture(tele, (2, 3), device="cpu")
    capture.maybe_start(2, program="sync")
    assert capture.profiling is False
    (event,) = tele.hotspots()
    assert (event["status"], event["program"]) == ("unavailable", "sync")
    assert (event["round_first"], event["round_last"]) == (2, 2)
    assert "unwritable" in event["reason"]
    assert tele.counters.get("hotspot_windows_unavailable") == 1
    # spent: asking again neither starts nor re-emits
    capture.maybe_start(3, program="sync")
    assert capture.profiling is False and len(tele.hotspots()) == 1
    capture.maybe_stop(99)
    assert "window unavailable" in capsys.readouterr().out


class _Boom:
    def __init__(self, *args, **kwargs):
        pass

    def start(self):
        raise RuntimeError("profiler backend unavailable")


def test_capture_degrades_when_the_profiler_raises_at_start(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.profiler, "profile", _Boom)
    tele = _Tele(tmp_path)
    capture = HotspotCapture(tele, (1, 1), device="cpu")
    capture.maybe_start(1, program="fused")
    assert capture.profiling is False
    (event,) = tele.hotspots()
    assert event["status"] == "unavailable" and "start failed" in event["reason"]
    assert tele.counters.get("hotspot_windows_unavailable") == 1
    capsys.readouterr()


def test_capture_degrades_when_another_profiler_is_active(tmp_path, monkeypatch, capsys):
    """A second ``start`` would end the first profiler's session rather
    than raise, so the window refuses to open beside another one."""
    monkeypatch.setattr(capture_mod, "_profiler_active", lambda: True)
    tele = _Tele(tmp_path)
    capture = HotspotCapture(tele, (1, 1), device="cpu")
    capture.maybe_start(1, program="pipelined")
    (event,) = tele.hotspots()
    assert event["status"] == "unavailable" and "already active" in event["reason"]
    capsys.readouterr()


class _Silent:
    def __init__(self, *args, **kwargs):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        pass


def test_capture_counts_an_empty_window(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.profiler, "profile", _Silent)
    tele = _Tele(tmp_path)
    capture = HotspotCapture(tele, (1, 1), device="cpu")
    capture.maybe_start(1, program="sync")
    assert capture.profiling
    capture.maybe_stop(force=True)
    (event,) = tele.hotspots()
    assert event["status"] == "empty"
    assert tele.counters.get("hotspot_windows_empty") == 1
    capsys.readouterr()


def test_capture_with_telemetry_disabled_is_inert(tmp_path):
    tele = _Tele(tmp_path, enabled=False)
    capture = HotspotCapture(tele, (1, 2), device="cpu")
    assert capture.window is None
    capture.maybe_start(1)
    assert capture.profiling is False and tele.events.rows == []


EXECUTORS = {"run": ("sync", {}), "run_fast": ("fused", {"chunk_size": 2}),
             "pipeline": ("pipelined", {})}


def _run(directory: Path, how: str, window: str, monitor: bool = False):
    cfg = Config(**{**SMALL, "local_backend": "xla", "log_path": str(directory),
                    "pipeline": how == "pipeline", "pipeline_depth": 2,
                    "telemetry": TelemetryConfig(hotspots=window, monitor=monitor,
                                                 monitor_port=0)})
    sim = Simulator(cfg, device="cpu")
    kwargs = EXECUTORS[how][1]
    if how == "run_fast":
        state, _ = sim.run_fast(save_checkpoints=False, verbose=False, **kwargs)
    else:
        state, _ = sim.run(save_checkpoints=False, verbose=False)
    return sim, state


@pytest.mark.parametrize("how", list(EXECUTORS))
def test_a_window_on_each_executor(how, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "on"))
    sim, state = _run(tmp_path / "on", how, "2:3", monitor=True)
    try:
        port = sim.monitor.port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/hotspots", timeout=10) as r:
            windows = json.loads(r.read())["windows"]
        metrics = sim.monitor.metrics_text()
    finally:
        sim.close()
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "off"))
    off_sim, off = _run(tmp_path / "off", how, "")
    off_sim.close()
    with open(tmp_path / "on" / "events.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    (window,) = [e for e in events if e["kind"] == "hotspot"]
    seam = EXECUTORS[how][0]
    assert (window["status"], window["program"]) == ("ok", seam)
    assert window["round_last"] == 3 and window["books_close"]
    assert all(jax_validate_event(e) == [] for e in events)
    assert window["trace"].endswith(".cpu.trace.json.gz")
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(state["global_params"]),
                                                 pt.tree_leaves(off["global_params"])))
    assert hotspots_from_events(events) == jax_hotspots_from_events(events)
    assert windows[seam]["host_bound_fraction"] == window["host_bound_fraction"]
    assert f'attackfl_host_bound_fraction{{program="{seam}"}}' in metrics
    # the ledger's join: JAX's derive_record gives the port's block
    (appended,), _ = LedgerStore(str(tmp_path / "on" / "ledger")).load()
    theirs = jax_derive_record(events, fingerprint=sim.checkpoints.fingerprint)
    assert appended["hotspots"] == theirs["hotspots"] == record.derive_record(
        events, fingerprint=sim.checkpoints.fingerprint)["hotspots"]
    assert appended["hotspots"]["status_counts"] == {"ok": 1}
    capsys.readouterr()
    if how == "run":
        # the exit codes of JAX's command on its own traces: a usable
        # window, a directory with none, a diff with itself and with
        # nothing to mine, usage errors
        jax_real = str(JAX_CORPUS / "real")
        on, off = str(tmp_path / "on"), str(tmp_path / "off")
        cases = ((["show", on], ["show", jax_real]), (["show", off], ["show", off]),
                 (["show", on, "--json"], ["show", jax_real, "--json"]),
                 (["diff", on, on], ["diff", jax_real, jax_real]),
                 (["diff", on, off], ["diff", jax_real, off]),
                 (["show", on, "--top"], ["show", jax_real, "--top"]), (["bogus"], ["bogus"]))
        for ours, theirs in cases:
            assert cli.main(["hotspots", *ours]) == jax_hotspots_main(theirs), ours
        assert cli.main(["hotspots", "show", on]) == 0
        assert "books close: True" in capsys.readouterr().out
