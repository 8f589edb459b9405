"""The launch path's serve steps with the dense decode's designs side by side.

Runs each ``chip_smoke.LAUNCH_SERVE`` step (Qwen3-0.6B at decode_32k,
Gemma2-2B at long_500k; ``chip_smoke.launch_serve_setup``) with the bf16
dense decode in turn as:

  shipped       the committed wrapper and kernel (one cooperative launch);
  split_body    the split-KV body it replaced (``ragged_decode/split_body``
                of ``chip_smoke.variant_sources``): its f32 scratch made a
                call and two launches, as that design's wrapper did;
  plain_launch  the shipped kernel launched with ``cudaLaunchKernel``
                instead of ``cudaLaunchCooperativeKernel`` (timing only:
                the grid is the SMs' resident capacity and nothing else
                runs, so every CTA is resident and its waits end)

in interleaved blocks (A B C C B A, twice), each ``STEPS`` steps timed
with CUDA events (the step), the host clock (until the step's last launch
is queued) and the host clock around the decode's C entry (its launch
calls).  Then one step of each arm under torch.profiler: the device time
of every kernel (the card's busy and idle share of the step) and the host
time of the CUDA runtime's launch calls.  Every arm's tokens are held
finite and its log-probs <= 0.

    python3 tools/dense_decode_serve_ab.py    # on the card; ~3 min

Prints one JSON line per shape and writes
``chiprun_out/dense_decode_serve_ab.jsonl``.
"""
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

STEPS = 8
ORDER = ("shipped", "split_body", "plain_launch", "plain_launch",
         "split_body", "shipped") * 2


class TimedLib:
    """A loaded library whose ``ragged_decode_attention`` entry adds its
    host seconds to ``seconds``; every other name is the library's."""

    def __init__(self, lib):
        self.lib, self.seconds, self.calls = lib, 0.0, 0

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def ragged_decode_attention(self, *args):
        t0 = time.perf_counter()
        rc = self.lib.ragged_decode_attention(*args)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return rc


def bind(rdm, build, lib):
    """``lib`` with the wrapper's argument types (``rdm._bind``)."""
    load, saved = build.load, rdm._lib
    build.load, rdm._lib = (lambda name: lib), None
    try:
        return rdm._bind()
    finally:
        build.load, rdm._lib = load, saved


def split_body_wrapper(torch, rdm, build, lib):
    """The split body's call as its wrapper made it: f32 partials for
    ``ragged_decode_splits(S)`` splits made a call, then the split and
    merge launches."""
    def call(q, k_cache, v_cache, kv_len, softcap=0.0, window=0,
             kv_start=None):
        B, H, D = q.shape
        S, Kh = k_cache.shape[1], k_cache.shape[2]
        dev = q.device
        out = torch.empty_like(q)
        ml, acc = build.split_scratch(lib.ragged_decode_splits(S), B, H, D,
                                      dev)
        rc = lib.ragged_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(), build.data_ptr(kv_start), out.data_ptr(),
            None, build.data_ptr(ml), build.data_ptr(acc), None, None, B, H,
            S, Kh, D, float(softcap), 1, build.stream_ptr(dev))
        build.check(rc, "split_body")
        return out
    return call


def profile_step(torch, step):
    """One ``step()`` under torch.profiler: the step's ms (CUDA events),
    the device ms of its kernels (all, and the decode's), and the host ms
    and count of each CUDA launch call seen."""
    from torch.profiler import ProfilerActivity, profile
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.record()
        step()
        e.record()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels, launch = {}, {}
    for ev in prof.events():
        if ev.device_type == cuda:
            kernels.setdefault(ev.key, []).append(
                ev.self_device_time_total / 1e3)
        elif "Launch" in ev.key and ev.key.startswith(("cuda", "cu")):
            n, t = launch.get(ev.key, (0, 0.0))
            launch[ev.key] = (n + 1, t + ev.cpu_time_total / 1e3)
    busy = sum(sum(v) for v in kernels.values())
    decode = {k[:80]: {"launches": len(v), "ms": sum(v)}
              for k, v in kernels.items() if "decode" in k}
    step_ms = s.elapsed_time(e)
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / step_ms) if step_ms else None,
            "kernels": sum(len(v) for v in kernels.values()),
            "decode_kernels": decode,
            "launch_calls": {k: {"calls": n, "host_ms": t}
                             for k, (n, t) in launch.items()}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dense_decode_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ragged_decode_attention as rdm
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.OUT.mkdir(exist_ok=True)
    cs.LINES = cs.OUT / "dense_decode_serve_ab.jsonl"
    cs.LINES.write_text("")
    rd = (build.CSRC / "ragged_decode_attention.cu").read_text()
    dd = (build.CSRC / "dense_decode_hopper.cuh").read_text()
    coop = "cudaLaunchCooperativeKernel("
    if coop not in dd:
        raise SystemExit("the shipped kernel has no cooperative launch")
    sources = {
        "split_body": cs.variant_sources()["ragged_decode/split_body"],
        "plain_launch": ("ragged_decode_attention", {
            "ragged_decode_attention.cu": rd,
            "dense_decode_hopper.cuh": dd.replace(coop, "cudaLaunchKernel(")})}
    procs = cs.start_variant_builds(sources)
    shipped = TimedLib(rdm._bind())
    built_libs = cs.finish_variant_builds(procs)
    if cs.FAILURES:
        return 1
    plain = TimedLib(bind(rdm, build, built_libs["plain_launch"][1]))
    body = TimedLib(bind(rdm, build, built_libs["split_body"][1]))
    kernel = ops.ragged_decode_attention
    arms = {"shipped": (kernel, shipped),
            "split_body": (split_body_wrapper(torch, rdm, build, body), body),
            "plain_launch": (kernel, plain)}

    def use(arm):
        fn, lib = arms[arm]
        ops.ragged_decode_attention = fn
        rdm._lib = lib if arm != "split_body" else shipped
        return lib

    rows = []
    try:
        for label, (arch, shape_name, B) in cs.LAUNCH_SERVE.items():
            cfg, built, params, cache, tok, kv, nrows, S = \
                cs.launch_serve_setup(torch, dev, arch, shape_name, B)
            state = {"tok": tok, "cache": cache, "kv": kv, "lps": []}

            def step():
                tok, lp, state["cache"] = built.fn(params, state["tok"],
                                                   state["cache"],
                                                   state["kv"])
                state["tok"] = tok
                state["lps"].append(lp)
                state["kv"] = state["kv"] + 1

            times = {a: {"step_ms": [], "host_ms": [], "entry_ms": []}
                     for a in arms}
            for arm in arms:                   # warm every arm's path
                use(arm)
                for _ in range(2):
                    step()
            torch.cuda.synchronize()
            for arm in ORDER:
                lib = use(arm)
                for _ in range(STEPS):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    lib.seconds = 0.0
                    s.record()
                    t0 = time.perf_counter()
                    step()
                    t1 = time.perf_counter()
                    e.record()
                    e.synchronize()
                    times[arm]["step_ms"].append(s.elapsed_time(e))
                    times[arm]["host_ms"].append(1e3 * (t1 - t0))
                    times[arm]["entry_ms"].append(1e3 * lib.seconds)
            profiles = {}
            for arm in arms:
                use(arm)
                step()
                torch.cuda.synchronize()
                profiles[arm] = profile_step(torch, step)
            lps = torch.stack(state["lps"]).float().cpu()
            cs.check(bool(torch.isfinite(lps).all())
                     and bool((lps <= 0).all()),
                     f"serve_ab/{label}: log-probs not finite or above 0")
            row = {"phase": "dense_decode_serve_ab", "label": label,
                   "model": cfg.name, "layers": cfg.num_layers,
                   "shape": shape_name, "batch": B, "cache_rows": nrows,
                   "card": cs.card_name_and_power(), "steps_a_block": STEPS,
                   "order": list(ORDER),
                   "arms": {a: {"step_ms_median":
                                statistics.median(v["step_ms"]),
                                "host_ms_median":
                                statistics.median(v["host_ms"]),
                                "entry_ms_median":
                                statistics.median(v["entry_ms"]),
                                **v, "profile": profiles[a]}
                            for a, v in times.items()}}
            cs.emit(row)
            rows.append(row)
            del params, cache, built, state
            cs.release(torch)
    finally:
        use("shipped")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
