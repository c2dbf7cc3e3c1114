"""chip_smoke's profiled decode window (fault 11's pin).

On the card Kineto keeps a device record only if its stamp, the device's
clock as CUPTI converts it to the host's, lies inside the host's
recording window, and the two clocks disagree by milliseconds: a window
closed right after its final synchronize dropped its last records, an
RMSNorm among them.  ``FakeKineto`` stands in for ``torch.profiler.profile``
with that rule, and a fake served model launches its kernels into it, so
``decode_breakdown`` runs here on the CPU as it does on the card."""
import importlib.util
import pathlib
import time
from types import SimpleNamespace

import pytest
pytest.importorskip("torch")
import torch
from torch.autograd import DeviceType

from repro_torch import kernels as K
from repro_torch.configs import get_arch

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYERS = 4
LAYER_S = 0.005     # host time of a layer's launches
# Device stamps this much after the host's clock: more than a call's
# host time, less than PROFILE_PAUSE_S.  A window closed at the sync
# loses its last records unless the host stalls this long before closing.
SKEW_S = 0.05
RMS = "void (anonymous namespace)::rmsnorm_row_kernel<__nv_bfloat16, 1>(...)"
SPLIT = ("void (anonymous namespace)::flash_attention_split_kernel<"
         "__nv_bfloat16, 1>(...)")
MERGE = ("void (anonymous namespace)::flash_attention_merge_kernel<"
         "__nv_bfloat16>(...)")
GEMM = "nvjet_tst_64x8_64x16_2x1_v_bz_NNT"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    def __init__(self, corr, name, device):
        self._c, self._n, self._d = corr, name, device

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def device_type(self):
        return self._d


class FakeKineto:
    """``torch.profiler.profile`` under a one-cycle schedule: recording
    runs from its first ``step()`` to its second.  Each launch leaves a
    runtime record at the host's time and a device record ``skew`` s
    later; a record is kept only if its own stamp lies inside the window.
    In a window of ``lossy``'s way, the device records of the launches
    numbered in ``drop`` (in the window, from 1) are lost for no reason
    of time."""
    active = None

    def __init__(self, *_, skew=SKEW_S, drop=(), lossy=None, **__):
        self.skew, self.drop, self.lossy = skew, set(drop), lossy
        self.steps, self.start, self.end = 0, None, None
        self.launches, self.ways = [], set()

    def __enter__(self):
        FakeKineto.active = self
        return self

    def __exit__(self, *_):
        FakeKineto.active = None

    def step(self):
        self.steps += 1
        if self.steps == 1:
            self.start = time.perf_counter()
        elif self.steps == 2:
            self.end = time.perf_counter()

    def launch(self, key, way):
        now = time.perf_counter()
        self.launches.append((now, now + self.skew, key))
        self.ways.add(way)

    def _kept(self):
        """The numbers (from 1, over all launches) of the launches whose
        runtime record the window keeps, and (number, key) of the device
        records it keeps: each record by its own stamp."""
        inside = [i for i, (t, _, _) in enumerate(self.launches, 1)
                  if self.start <= t <= self.end]
        drop = ({inside[n - 1] for n in self.drop}
                if self.lossy in self.ways else set())
        device = [(i, key) for i, (_, d, key) in enumerate(self.launches, 1)
                  if self.start <= d <= self.end and i not in drop]
        return inside, device

    def key_averages(self):
        rows = {}
        for _, key in self._kept()[1]:
            rows[key] = rows.get(key, 0) + 1
        return [SimpleNamespace(key=k, count=c, device_time_total=1.0 * c)
                for k, c in rows.items()]

    @property
    def profiler(self):
        inside, device = self._kept()
        events = [_Event(i, "cudaLaunchKernel", DeviceType.CPU)
                  for i in inside]
        events += [_Event(i, key, DeviceType.CUDA) for i, key in device]
        return SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: events))


def fake_call(tok, way):
    """A served decode call's launches, counted as the wrappers count
    them: per layer an RMSNorm, a split-K attention (split and merge) and
    a product; then the final RMSNorm and the head."""
    prof = FakeKineto.active
    def record(key):
        if prof is not None:
            prof.launch(key, way)
    for _ in range(LAYERS):
        record(RMS)
        K.LAUNCHES["rmsnorm"] += 1
        record(SPLIT)
        record(MERGE)
        K.LAUNCHES["flash_attention"] += 1
        record(GEMM)
        time.sleep(LAYER_S)
    record(RMS)
    K.LAUNCHES["rmsnorm"] += 1
    record(GEMM)
    return torch.zeros((1, tok.shape[1], 8))


def fake_backend():
    cfg = get_arch("deepseek-v2-lite-16b").smoke
    return SimpleNamespace(
        cfg=cfg, max_len=64, prefill_chunk=4, device=torch.device("cpu"),
        model=None,
        api=SimpleNamespace(decode_step=lambda model, state, t, pos: (
            fake_call(t, "eager"), state)),
        fresh_state=lambda lane=0: {"kv": torch.zeros(2)},
        model_call=lambda lane, t, pos: fake_call(t, "graphed"),
        _sample=lambda logits: torch.argmax(
            logits[:, -1:], dim=-1).to(torch.int32))


@pytest.fixture
def card(monkeypatch):
    """The device sync a no-op and ``torch.profiler.profile`` a
    ``FakeKineto`` of the given keywords."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_, **__: None)
    K.reset_launches()

    def use(**fake):
        monkeypatch.setattr(torch.profiler, "profile",
                            lambda *a, **kw: FakeKineto(*a, **kw, **fake))
    return use


def test_lost_records_places_the_lost_launches():
    cs = _chip_smoke()
    kern = [("cudaLaunchKernel", 1)] * 6
    assert cs.lost_records(kern) == ""
    # eager: the last two launches have no device record
    assert cs.lost_records(kern[:4] + [("cudaLaunchKernel", 0)] * 2) == (
        "2 device records of 2 launches, launch 5 to 6 of 6 (the window's "
        "last launches)")
    # graphed: the last replay lost part of its graph, then the eager
    # argmax and cast launched after it lost theirs
    graphed = [("cudaGraphLaunch", 40), ("cudaLaunchKernel", 1),
               ("cudaLaunchKernel", 1), ("cudaGraphLaunch", 37),
               ("cudaLaunchKernel", 0), ("cudaLaunchKernel", 0)]
    assert cs.lost_records(graphed) == (
        "5 device records of 3 launches, launch 4 to 6 of 6 (the window's "
        "last launches)")
    # a record lost inside the window is placed, not called the last
    assert cs.lost_records(kern[:2] + [("cudaMemcpyAsync", 0)] + kern[3:]) \
        == "1 device records of 1 launches, launch 3 to 3 of 6"
    # the warm-up call's last records stamped after the window opened
    assert cs.lost_records(kern, 14) == (
        "14 device records of launches made before the window opened")
    assert cs.lost_records(kern[:5] + [("cudaLaunchKernel", 0)], 3) == (
        "1 device records of 1 launches, launch 6 to 6 of 6 (the window's "
        "last launches); 3 device records of launches made before the "
        "window opened")


def test_decode_window_closes_after_the_device_records(card):
    """The repaired window opens PROFILE_PAUSE_S after the warm-up's
    synchronize and closes as long after the final one, so the warm-up's
    records stay out and the window's own stay in: each way's first
    window is whole and gives the row."""
    cs = _chip_smoke()
    card()
    bd = cs.decode_breakdown(fake_backend())
    assert cs.PROFILE_PAUSE_S > SKEW_S
    steps = cs.DECODE_PROFILE_STEPS
    want = {"rmsnorm": steps * (LAYERS + 1),
            "flash_attention": steps * LAYERS}
    for row in (bd, bd["eager"]):
        assert row["profiled_launches"] == row["counted_launches"] == want
        assert row["windows"] == [{"profiled": want, "counted": want,
                                   "lost_at": ""}]
        assert row["launches"] == 4 * LAYERS + 2
        assert row["symbols"]["flash_attention_merge_kernel"] == \
            steps * LAYERS


def test_window_closed_at_the_sync_loses_its_last_records(card,
                                                          monkeypatch):
    """The parent's window, opened right at the warm-up's synchronize
    and closed right at the final one: with the device's stamps behind
    the host's every window took in the warm-up's last records and lost
    its own last ones, an RMSNorm among them, and the phase fails naming
    the model, the way, each window's counts and where the records
    went."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "PROFILE_PAUSE_S", 0.0)
    card()
    with pytest.raises(AssertionError) as err:
        cs.decode_breakdown(fake_backend())
    msg = str(err.value)
    assert msg.startswith("dsv2-smoke's graphed decode call: none of 3 "
                          "profiled windows of 8 calls was whole")
    for i in (1, 2, 3):
        assert f"window {i} {{'rmsnorm': " in msg
    assert msg.count("(the window's last launches); ") == 3
    assert msg.count("device records of launches made before the window "
                     "opened") == 3
    assert "against {'rmsnorm': 40, 'flash_attention': 32}" in msg


def test_a_record_lost_inside_the_window_still_fails(card):
    """A record lost for another reason, inside the repaired window, in
    every eager window: the graphed way passes, the eager way fails and
    the message says so and where the record was."""
    cs = _chip_smoke()
    card(drop=(1,), lossy="eager")
    with pytest.raises(AssertionError) as err:
        cs.decode_breakdown(fake_backend())
    msg = str(err.value)
    assert msg.startswith("dsv2-smoke's eager decode call: none of 3 "
                          "profiled windows")
    assert msg.count("1 device records of 1 launches, launch 1 to 1 of "
                     f"{cs.DECODE_PROFILE_STEPS * (4 * LAYERS + 2)}") == 3
    assert "last launches" not in msg
    assert "'rmsnorm': 39" in msg
