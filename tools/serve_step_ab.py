"""The Qwen3-0.6B serve paths' decode-step times of two source trees, on
one card in one call.

    python3 tools/serve_step_ab.py OTHER_ROOT

``OTHER_ROOT`` is another checkout of the repo (for example the parent
commit unpacked with ``git archive``).  Each run is a process of its own
that builds its tree's kernels (``kernels/build.py``, before the timing),
loads Qwen3-0.6B at full width in bf16 with random weights from seed 0,
and serves ``chip_smoke.py``'s requests on its main path (paged pool,
fused greedy head; 96 requests) and its dense path (``paged=False``; 32
requests), each timed by ``chip_smoke.run_path`` (host clock around each
engine step).  The runs go other, this, this, other; the script prints one
JSON line a run and a last line with each tree's median decode-step ms a
path, and writes them to ``chiprun_out/serve_step_ab.json``.  Compare the
two trees only within one call: the host's speed moves step times between
calls.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATHS = {"main": (dict(fused_sampling=True), 24, 1),
         "dense": (dict(paged=False), 8, 4)}


def child(root: Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    cfg = get_config("qwen3_0_6b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    kw = dict(capacity=32, max_total_len=2048, max_gen_len=128,
              eos_id=151645, pad_id=0, temperature=0.0)
    out = {"root": str(root), "build_s": build_s}
    for name, (opts, groups, seed) in PATHS.items():
        engine = SlotEngine(model, lambda: params, **opts, **kw)
        reqs = cs.make_requests(groups, 4, 64, 1024, cfg.vocab_size,
                                seed=seed)
        _, summ = cs.run_path(torch, ops, engine, reqs)
        out[name] = {k: summ[k] for k in (
            "decode_step_ms_median", "decode_step_ms_p90", "steps",
            "tokens_per_s", "launches")}
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--child", str(root)], capture_output=True,
                           text=True, cwd=root)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        run = dict(json.loads(r.stdout.strip().splitlines()[-1]), tree=label)
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    for label in ("other", "this"):
        summary[label] = {p: statistics.median(
            r[p]["decode_step_ms_median"] for r in runs if r["tree"] == label)
            for p in PATHS}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_step_ab.json").write_text(
        json.dumps({"runs": runs, "summary": summary}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
