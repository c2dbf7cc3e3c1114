"""chip_smoke's profiled windows (the pins of faults 11 and 12).

On the card Kineto keeps a device record only if its stamp, the device's
clock as CUPTI converts it to the host's, lies inside the host's
recording window, and the two clocks disagree by milliseconds: a window
closed right after its final synchronize dropped its last records, an
RMSNorm among them (fault 11).  A window can also lose records in its
middle or at its start (fault 12).  ``FakeKineto`` stands in for
``torch.profiler.profile`` with both rules, and a fake served model and a
fake trainer launch their kernels into it, so ``decode_breakdown``,
``train_breakdown``, ``range_breakdown`` and ``_profile_rows`` run here on
the CPU as they do on the card."""
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
# The device records of a profile's first launches are lost (CUPTI's
# start on the card: fault 12).
LAZY_LAUNCHES = 6
RMS = "void (anonymous namespace)::rmsnorm_row_kernel<__nv_bfloat16, 1>(...)"
SPLIT = ("void (anonymous namespace)::flash_attention_split_kernel<"
         "__nv_bfloat16, 1>(...)")
MERGE = ("void (anonymous namespace)::flash_attention_merge_kernel<"
         "__nv_bfloat16>(...)")
GEMM = "nvjet_tst_64x8_64x16_2x1_v_bz_NNT"
WKV = "void (anonymous namespace)::wkv6_kernel<__nv_bfloat16>(...)"
# A fake training step's launches: per layer an RMSNorm, a WKV-6 and a
# product forward, then two products inside the layer's wkv6_backward
# range; then the optimizer's product.
STEP_LAUNCHES = 5 * LAYERS + 1


def _chip_smoke(warm_up=True):
    """chip_smoke, its CUPTI warm-up launching into the ``FakeKineto``
    (with ``warm_up`` False, nothing: a window recorded from its first
    launch on)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def warm():
        for _ in range(mod.CUPTI_WARM_UP_LAUNCHES if warm_up else 0):
            _record(GEMM, "warm-up")
    mod._warm_up_cupti = warm
    return mod


def _record(key, way):
    if FakeKineto.active is not None:
        FakeKineto.active.launch(key, way)


class _Event:
    def __init__(self, corr, name, device):
        self._c, self._n, self._d = corr, name, device

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False


class FakeKineto:
    """``torch.profiler.profile``: recording runs from its first
    ``step()`` to its second under a one-cycle schedule, else from entry
    to exit.  Each launch leaves a runtime record at the host's time and
    a device record ``skew`` s later; a record is kept only if its own
    stamp lies inside the window.  In a window where ``lossy``'s way
    launched (any window when ``lossy`` is None), the device records of
    the launches numbered in ``drop`` (in the window, from 1) are lost
    for no reason of time: in the window's middle or at its start.  And
    the device records of the profile's first ``lazy`` launches are lost
    wherever they fall, as the card lost them (fault 12)."""
    active = None

    def __init__(self, *_, skew=SKEW_S, drop=(), lossy=None, schedule=None,
                 lazy=LAZY_LAUNCHES, **__):
        self.skew, self.drop, self.lossy = skew, set(drop), lossy
        self.lazy = lazy
        self.scheduled = schedule is not None
        self.steps, self.start, self.end = 0, None, None
        self.launches, self.ways, self.ranges = [], set(), []

    def __enter__(self):
        FakeKineto.active = self
        if not self.scheduled:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *_):
        FakeKineto.active = None
        if not self.scheduled:
            self.end = time.perf_counter()

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
                if self.lossy is None or self.lossy in self.ways else set())
        drop |= set(range(1, self.lazy + 1))
        device = [(i, key) for i, (_, d, key) in enumerate(self.launches, 1)
                  if self.start <= d <= self.end and i not in drop]
        return inside, device

    def key_averages(self):
        rows = {}
        for _, key in self._kept()[1]:
            rows[key] = rows.get(key, 0) + 1
        return [SimpleNamespace(key=k, count=c, device_time_total=1.0 * c)
                for k, c in rows.items()]

    def events(self):
        """The FunctionEvents of a CPU and CUDA profile: each kept device
        record (1 us), and each profiler range begun inside the window,
        with the device time of the kept records of its launches."""
        device = self._kept()[1]
        evs = [SimpleNamespace(name=key, device_type=DeviceType.CUDA,
                               device_time_total=1.0,
                               is_user_annotation=False)
               for _, key in device]
        evs += [SimpleNamespace(name=name, device_type=DeviceType.CPU,
                                device_time_total=float(sum(
                                    first <= i <= last for i, _ in device)),
                                is_user_annotation=True)
                for name, first, last, t in self.ranges
                if self.start <= t <= self.end]
        return evs

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


def fake_step():
    """A training step's launches (``STEP_LAUNCHES``), the wrappers'
    counted as they count them."""
    prof = FakeKineto.active
    for _ in range(LAYERS):
        _record(RMS, "train")
        K.LAUNCHES["rmsnorm"] += 1
        _record(WKV, "train")
        K.LAUNCHES["wkv6"] += 1
        _record(GEMM, "train")
        time.sleep(LAYER_S)
    for _ in range(LAYERS):
        if prof is not None:
            first = len(prof.launches) + 1
            prof.ranges.append(("wkv6_backward", first, first + 1,
                                time.perf_counter()))
        _record(GEMM, "train")
        _record(GEMM, "train")
    _record(GEMM, "train")


class FakeTrainer:
    cfg = get_arch("rwkv6-3b").smoke

    def __init__(self):
        self.step = 0

    def run(self, steps):
        for _ in range(steps):
            fake_step()
            self.step += 1


@pytest.fixture
def card(monkeypatch):
    """The device sync a no-op and ``torch.profiler.profile`` a
    ``FakeKineto`` of the given keywords; ``windows`` lists the launches
    each profile opened from then on drops (``drop``), one set a
    profile."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_, **__: None)
    K.reset_launches()

    def use(windows=(), **fake):
        drops = [set(d) for d in windows]

        def make(*a, **kw):
            prof = FakeKineto(*a, **kw, **fake)
            if drops:
                prof.drop = drops.pop(0)
            return prof
        monkeypatch.setattr(torch.profiler, "profile", make)
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


def test_train_breakdown_records_again_a_window_that_lost_records(card):
    """A step whose window lost a WKV-6 record in its middle: one more
    step is recorded, and the row is that whole window's, every
    window kept with where its records went."""
    cs = _chip_smoke()
    card(windows=[{5}, ()])
    bd = cs.train_breakdown(FakeTrainer())
    want = {"rmsnorm": LAYERS, "wkv6": LAYERS}
    assert bd["windows"] == [
        {"profiled": {"rmsnorm": LAYERS, "wkv6": LAYERS - 1},
         "counted": want,
         "lost_at": f"1 device records of 1 launches, launch 5 to 5 of "
                    f"{STEP_LAUNCHES}"},
        {"profiled": want, "counted": want, "lost_at": ""}]
    assert bd["profiled_launches"] == bd["counted_launches"] == want
    assert bd["operations"] == STEP_LAUNCHES
    assert bd["busy_ms"] == pytest.approx(STEP_LAUNCHES / 1e3)
    assert bd["ported_ms"] == {"rmsnorm": LAYERS / 1e3,
                               "wkv6": LAYERS / 1e3}


@pytest.mark.parametrize("which", ["train", "range"])
def test_a_step_that_never_keeps_its_records_fails(card, which):
    """Every window lost the step's first launches' records: after
    PROFILE_TRIES windows the phase fails naming the model, each
    window's counts and the launches that lost records."""
    cs = _chip_smoke()
    card(windows=[{1, 2, 3}] * 3)
    with pytest.raises(AssertionError) as err:
        if which == "train":
            cs.train_breakdown(FakeTrainer())
        else:
            cs.range_breakdown(FakeTrainer(), ("wkv6_backward",))
    msg = str(err.value)
    what = ("training step" if which == "train"
            else "training step with profiler ranges")
    assert msg.startswith(f"rwkv6-smoke's {what}: none of 3 profiled "
                          f"windows was whole")
    for i in (1, 2, 3):
        assert (f"window {i} {{'rmsnorm': {LAYERS - 1}, 'wkv6': "
                f"{LAYERS - 1}}} against {{'rmsnorm': {LAYERS}, 'wkv6': "
                f"{LAYERS}}}, 3 device records of 3 launches, launch 1 to 3 "
                f"of {STEP_LAUNCHES}") in msg
    assert "last launches" not in msg


def test_range_breakdown_holds_its_list_to_the_counter(card):
    """A record lost inside a wkv6_backward range leaves the ported
    counts equal, but the raw list shows it: one more step is recorded,
    and the ranges, busy time and launches are the whole window's."""
    cs = _chip_smoke()
    card(windows=[{3 * LAYERS + 2}, ()])
    out = cs.range_breakdown(FakeTrainer(), ("wkv6_backward",))
    want = {"rmsnorm": LAYERS, "wkv6": LAYERS}
    assert [w["lost_at"] for w in out["windows"]] == [
        f"1 device records of 1 launches, launch {3 * LAYERS + 2} to "
        f"{3 * LAYERS + 2} of {STEP_LAUNCHES}", ""]
    assert out["windows"][0]["profiled"] == want
    assert out["profiled_launches"] == out["counted_launches"] == want
    assert out["ranges"] == {"wkv6_backward": {
        "calls": LAYERS, "device_ms": pytest.approx(2 * LAYERS / 1e3)}}
    assert out["busy_ms"] == pytest.approx(STEP_LAUNCHES / 1e3)


def _kernel_call():
    _record(RMS, "kernel")
    K.LAUNCHES["rmsnorm"] += 1


def _library_call():
    _record(GEMM, "library")


def test_profile_rows_records_again_a_lossy_list(card):
    """``_profile_rows`` takes a window again when it lost a record, for
    a ported kernel (its launches held to the counter) and a library
    call alike, and returns the whole window's rows, shaped as before."""
    cs = _chip_smoke()
    card(windows=[{2}, ()])
    assert cs._profile_rows(_kernel_call, 5) == [(5.0, 5, RMS)]
    card(windows=[{1}, ()])
    assert cs.device_ms(_kernel_call, "rmsnorm", 5) == pytest.approx(1e-3)
    card(windows=[{1}, ()])
    assert cs.library_device_ms(_library_call, 5) == pytest.approx(1e-3)


def test_profile_rows_refuses_a_lossy_list(card):
    """Every window lost a record: ``_profile_rows`` fails naming the
    calls, each window's counts and the launch that lost its record."""
    cs = _chip_smoke()
    card(windows=[{2}] * 3)
    with pytest.raises(AssertionError) as err:
        cs._profile_rows(_kernel_call, 5)
    msg = str(err.value)
    assert msg.startswith("5 calls of _kernel_call: none of 3 profiled "
                          "windows was whole")
    assert msg.count("{'rmsnorm': 4} against {'rmsnorm': 5}, 1 device "
                     "records of 1 launches, launch 2 to 2 of 5") == 3


def test_profile_rows_refuses_a_list_with_no_device_time(card):
    """A profile listing no device time is taken again, and fails
    after PROFILE_TRIES."""
    cs = _chip_smoke()
    card()
    with pytest.raises(AssertionError) as err:
        cs._profile_rows(lambda: None, 5)
    assert str(err.value).count("{} against {}, no device time listed") \
        == 3


def test_training_windows_are_logged(card, capsys):
    """Phases 17 and 27 log the row's window number and every window's
    lost records, so a loss on the card reads from the log alone."""
    cs = _chip_smoke()
    card(windows=[{5}, ()])
    cs.log_train_breakdown("27", cs.train_breakdown(FakeTrainer()))
    out = capsys.readouterr().out
    assert "(held equal; the row is window 2 of at most 3)" in out
    assert (f"[27]   training window 1: profiler {{'rmsnorm': {LAYERS}, "
            f"'wkv6': {LAYERS - 1}}}, launch counter {{'rmsnorm': {LAYERS}, "
            f"'wkv6': {LAYERS}}}, lost records: 1 device records of 1 "
            f"launches, launch 5 to 5 of {STEP_LAUNCHES}") in out
    assert "[27]   training window 2: " in out
    assert out.rstrip().endswith("lost records: none")


@pytest.mark.parametrize("which", ["train", "profile_rows"])
def test_without_the_warm_up_the_first_launches_lose_their_records(
        card, which):
    """Fault 12: the first launches under a freshly turned-on CUPTI lose
    their device records.  Without the warm-up launches before recording
    starts, every window loses its first launches and the phase fails
    naming them; with them (every other test here), the first window is
    whole."""
    cs = _chip_smoke(warm_up=False)
    card()
    with pytest.raises(AssertionError) as err:
        if which == "train":
            cs.train_breakdown(FakeTrainer())
        else:
            cs._profile_rows(_kernel_call, 5)
    msg = str(err.value)
    assert "none of 3 profiled windows was whole" in msg
    for i in (1, 2, 3):
        assert f"window {i} " in msg
    assert msg.count(" launches, launch 1 to ") == 3
