"""Where the resident attention kernel's time goes, on one NVIDIA GPU.

    python3 attention_probe.py [MODE ...]

MODE is any of timeline, variants, layouts, host, batches, edit, stream,
shapes, stream_timeline. With no argument it runs all nine. It prints the card's name and power limit first. It stands
beside chip_smoke.py, whose timing method it uses; nothing in the package or in
chip_smoke.py needs it.

  timeline  builds csrc/attention.cu with -DCONDMDI_PROBE_STAMPS (clock stamps at
            a CTA's milestones) and prints, for the served shape and the
            evaluation batch, the cycles since the CTA's start at which each
            was reached (percentiles over the CTAs);
  variants  builds it with -DCONDMDI_PROBE_OFF=<mask>, parts of the resident
            kernel switched off (the results are wrong, the times tell what
            each part costs), and times each as chip_smoke.py times phase 5;
  layouts   three of the variants at the evaluation batch's size with q, k, v as
            column views of one projection, as contiguous tensors, and with one
            dense head a row: does the time depend on where the bytes lie;
  host      the host's cost of one wrapper call, by part, beside one
            scaled_dot_product_attention call; and of one float32 call at MDM
            edit's shape (B=4) beside SDPA in float32;
  batches   kernel against scaled_dot_product_attention over batch sizes;
  edit      does the float32 route's gain show end to end: MDM `edit` through
            its main as chip_smoke.py's phase 16 runs it (float32, B=4, 1000-step
            DDPM), with float32 attention on route 2 as the package builds it,
            on route 2 with its kernel launched in stream order instead of as
            the split pass's programmatic dependent (-DCONDMDI_PROBE_OFF=256,
            `kOffPdl`), and on route 0, the streaming kernel
            (-DCONDMDI_PROBE_OFF=128, `kOffF32Route`, with `attention_route`
            answering "stream" for float32), in the order 2, 2', 0, 0, 2', 2
            twice: samples/s of each run, and each route's median and best;
            beside each, one wrapper call's host enqueue at edit's shape, one
            float32 MDM forward at B=4 on the host clock against its device
            time, and the host's time in that forward by event (torch.profiler,
            self CPU time);
  stream    the streaming route (route 0) at the shapes chip_smoke.py times it
            at, built with parts switched off as `variants` does (the same
            `ProbeOff` bits act on the streaming kernel: no scores, no P.V, no
            softmax, no stores, no Q copies), and its pack pass alone, by the
            library's `condmdi_attention_pack`; for bf16 shapes read in place,
            also the same call forced through the pack pass and forced to
            read in place (float32 split in shared memory);
  stream_timeline
            the streaming kernel's clock stamps (a -DCONDMDI_PROBE_STAMPS build):
            for the first item of each CTA, the cycles since the CTA's start at
            which consumer 0 had Q, finished tile 0, began tile j, saw its scores
            done and saw its softmax and tile j-1's P.V done,
            at the bf16 shapes read in place (percentiles over the CTAs);
  shapes    the wrapper at the same shapes as this tree's package builds it,
            each beside SDPA, a shape the wrapper refuses printed as refused:
            copied with chip_smoke.py into an earlier commit's unpacked tree
            (git archive into .chipwork/), it times that tree's kernel at these
            shapes in the same call as this one's.

The probe libraries are built into the package's build directory, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs  # the timing method and the card line
from condmdi_tpu_torch.ops import _build, attention

SOURCE = _build.CSRC_DIR / "attention.cu"
SERVED, BENCH = (8, 197, 512, 4), (128, 197, 512, 4)  # (B, T, D, H)
SLOTS = 32  # 8-byte stamps a CTA
# csrc/attention.cu `ProbeOff`
SCORES, PV, SOFTMAX, STORES, Q_LOADS, SLACK, SECOND_CTA = 1, 2, 4, 8, 16, 32, 64
F32_STREAM, NO_PDL = 128, 256  # float32 on route 0; route 2's kernel not the pass's dependent
ARITHMETIC = SCORES | PV | SOFTMAX
VARIANTS = {
    "as committed": 0,
    "no scores": SCORES,
    "no P.V": PV,
    "no softmax": SOFTMAX,
    "no output stores": STORES,
    "reference maximum moves every tile": SLACK,
    "one CTA an SM": SECOND_CTA,
    "no arithmetic": ARITHMETIC,
    "no arithmetic, no stores": ARITHMETIC | STORES,
    "K and V copies alone": ARITHMETIC | STORES | Q_LOADS,
    "K and V copies alone, one CTA an SM": ARITHMETIC | STORES | Q_LOADS | SECOND_CTA,
}
_started: dict[str, tuple] = {}  # define -> (library path, nvcc process or None)


def start_build(define: str) -> None:
    """Start nvcc on the kernel's source with one more -D, unless that library exists."""
    if define in _started:
        return
    digest = hashlib.sha256(SOURCE.read_bytes() + define.encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"probe_{digest}.so"
    proc = None
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-D{define}", "-o", str(out), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _started[define] = (out, proc)


def load(define: str) -> ctypes.CDLL:
    """The library built with `define`, bound, and put in place of the package's."""
    start_build(define)
    out, proc = _started[define]
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode:
            out.unlink(missing_ok=True)
            raise SystemExit(f"attention_probe: nvcc -D{define} failed:\n{log[-3000:]}")
        _started[define] = (out, None)
    lib = ctypes.CDLL(str(out))
    _build._bind_attention(lib)
    _build._libs["attention.cu"] = lib
    return lib


def off(mask: int) -> str:
    return f"CONDMDI_PROBE_OFF={mask}"


def qkv_sets(shape, dev, gen):
    """Column views of enough [B, T, 3D] projections to exceed the 50 MB L2."""
    B, T, D, _ = shape
    n = max(2, -(-64 * 2**20 // (B * T * 3 * D * 2)))
    return [torch.randn((B, T, 3 * D), generator=gen, device=dev).bfloat16().chunk(3, dim=-1)
            for _ in range(n)]


def kernel_us(sets, H) -> float:
    with torch.no_grad():
        ms, _ = cs.timed_ms(lambda q, k, v: attention._launch(q, k, v, H), sets)
    return ms * 1e3


def sdpa_us(sets, shape) -> float:
    B, T, D, H = shape
    heads_first = [tuple(t.view(B, T, H, D // H).transpose(1, 2) for t in s) for s in sets]
    ms, _ = cs.timed_ms(F.scaled_dot_product_attention, heads_first)
    return ms * 1e3


# --------------------------------------------------------------------------- #
# timeline
# --------------------------------------------------------------------------- #
def timeline(dev):
    lib = load("CONDMDI_PROBE_STAMPS")
    lib.condmdi_probe_stamps.argtypes = [ctypes.c_void_p]
    lib.condmdi_probe_stamps.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)
    names = {1: "barriers ready", 2: "copies and Q loads started, CTA synchronised", 30: "end"}
    for it in range(8):
        names.update({3 + 3 * it: f"item {it} begins",
                      4 + 3 * it: f"item {it}: tile 0 in place, its scores started",
                      5 + 3 * it: f"item {it} computed"})
    for shape in (SERVED, BENCH):
        B, T, _, H = shape
        sets = qkv_sets(shape, dev, gen)
        ctas = min(2 * torch.cuda.get_device_properties(dev).multi_processor_count,
                   B * H * -(-T // 64))
        lib.condmdi_probe_stamps(None)
        for s in sets:  # warm up, and leave the first set cold
            attention._launch(*s, H)
        stamps = torch.zeros(ctas * SLOTS, dtype=torch.int64, device=dev)
        lib.condmdi_probe_stamps(stamps.data_ptr())
        torch.cuda.synchronize()
        attention._launch(*sets[0], H)
        torch.cuda.synchronize()
        lib.condmdi_probe_stamps(None)
        d = stamps.view(ctas, SLOTS).cpu().numpy()
        print(f"[timeline] B={B} T={T}: {ctas} CTAs; cycles since each CTA's start, "
              f"p10 / p50 / p90 over the CTAs that got there", flush=True)
        for slot in sorted(names):
            seen = d[:, slot] > 0
            if seen.any():
                c = sorted(d[seen, slot] - d[seen, 0])
                p = [c[min(len(c) - 1, int(f * len(c)))] for f in (0.1, 0.5, 0.9)]
                print(f"[timeline]   {names[slot]:>44} ({seen.sum():3d} CTAs): "
                      f"{p[0]:7d} {p[1]:7d} {p[2]:7d}", flush=True)


# --------------------------------------------------------------------------- #
# variants
# --------------------------------------------------------------------------- #
def variants(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    data = {shape: qkv_sets(shape, dev, gen) for shape in (SERVED, BENCH)}
    for name, mask in VARIANTS.items():
        load(off(mask))
        times = [kernel_us(data[shape], shape[3]) for shape in (SERVED, BENCH)]
        print(f"[variants] {name:>38}: served {times[0]:6.1f} us, evaluation batch "
              f"{times[1]:6.1f} us", flush=True)
    _build._libs.pop("attention.cu")


def layouts(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = {  # the same bytes of q, k, v and the same number of (batch, head) pairs
        "column views, B=128 H=4 D=512": ((128, 197, 512, 4), False),
        "contiguous q, k, v, B=128 H=4 D=512": ((128, 197, 512, 4), True),
        "contiguous, one head a row, B=512 H=1 D=128": ((512, 197, 128, 1), True),
    }
    data = {}
    for name, (shape, contiguous) in cases.items():
        data[name] = [tuple(t.contiguous() for t in s) if contiguous else s
                      for s in qkv_sets(shape, dev, gen)]
    for variant in ("as committed", "no arithmetic", "K and V copies alone"):
        load(off(VARIANTS[variant]))
        for name, (shape, _) in cases.items():
            us = kernel_us(data[name], shape[3])
            print(f"[layouts] {variant:>22} | {name:44s}: {us:6.1f} us", flush=True)
    _build._libs.pop("attention.cu")


# --------------------------------------------------------------------------- #
# host, batches
# --------------------------------------------------------------------------- #
def per_call_us(fn, n=3000):
    """The host's time for one call of `fn`, the best of five rounds of n calls."""
    for _ in range(50):
        fn()
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return best * 1e6


def host(dev):
    B, T, D, H = SERVED
    q, k, v = torch.randn(B, T, 3 * D, device=dev).bfloat16().chunk(3, dim=-1)
    heads_first = tuple(t.view(B, T, H, D // H).transpose(1, 2) for t in (q, k, v))
    lib = _build.load_attention()
    out = torch.empty(B, T, D, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_entry():
        lib.condmdi_attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      B, T, H, D // H, q.stride(0), q.stride(1), 1, 1, stream, None)

    # float32 at MDM edit's shape (B=4): the route the package takes there
    f32 = torch.randn(4, T, 3 * D, device=dev).chunk(3, dim=-1)
    f32_heads_first = tuple(t.view(4, T, H, D // H).transpose(1, 2) for t in f32)
    f32_route = attention.attention_route(4, T, H, D // H, torch.float32)
    with torch.no_grad():
        for name, fn in [
            ("the wrapper (_launch)", lambda: attention._launch(q, k, v, H)),
            (f"the wrapper, float32 B=4 ({f32_route})", lambda: attention._launch(*f32, H)),
            ("scaled_dot_product_attention, float32 B=4",
             lambda: F.scaled_dot_product_attention(*f32_heads_first)),
            ("mha (through the autograd Function)", lambda: attention.mha(q, k, v, H)),
            ("the C entry alone, by ctypes", c_entry),
            ("torch.empty of the output", lambda: torch.empty((B, T, D), device=dev,
                                                              dtype=torch.bfloat16)),
            ("scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(*heads_first)),
        ]:
            print(f"[host] {name:>38}: {per_call_us(fn):6.2f} us a call", flush=True)


def batches(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    for B in (8, 16, 32, 64, 128, 256):
        shape = (B, 197, 512, 4)
        sets = qkv_sets(shape, dev, gen)
        print(f"[batches] B={B:3d} T=197 D=512 H=4: kernel {kernel_us(sets, 4):6.1f} us, "
              f"scaled_dot_product_attention {sdpa_us(sets, shape):6.1f} us", flush=True)


# --------------------------------------------------------------------------- #
# edit
# --------------------------------------------------------------------------- #
def host_by_event(label, call, iters=20, top=14):
    """The host's time in one forward by event: torch.profiler's self CPU time
    (operators and the CUDA runtime calls it sees), per forward, the largest first."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in events) / iters
    print(f"[edit]   {label}: {total:.1f} us of self CPU time a forward by the profiler; "
          f"the largest:", flush=True)
    for e in events[:top]:
        print(f"[edit]     {e.self_cpu_time_total / iters:8.1f} us  {e.count // iters:4d} x  "
              f"{e.key[:80]}", flush=True)


def edit(dev):
    import numpy as np

    from condmdi_tpu_torch.models.text import HashTextEncoder

    torch.backends.cuda.matmul.allow_tf32 = False  # as the CLI runs: device.float32_exact
    torch.backends.cudnn.allow_tf32 = False
    committed = attention.attention_route

    def streaming(B, T, H, hd, dtype):
        return "stream" if dtype == torch.float32 else committed(B, T, H, hd, dtype)

    routes = {"route 2": (None, committed), "route 2 in stream order": (off(NO_PDL), committed),
              "route 0": (off(F32_STREAM), streaming)}
    expect = {"route 2": "wgmma_f32", "route 2 in stream order": "wgmma_f32", "route 0": "stream"}
    argv = cs.MDM_CLI + ["--edit_mode", "benchmark_clip", "--imputate", "true"]
    B, T, D, H = cs.CLI_SAMPLES, cs.MDM_TOKENS, 512, 4
    q, k, v = torch.randn((B, T, 3 * D), device=dev).chunk(3, dim=-1)
    model = cs.build_mdm(dev, torch.float32)
    x = cs.seeded_noise((B, cs.T_FRAMES, cs.FEATS), dev, seed=13)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": torch.from_numpy(HashTextEncoder().encode(cs.PROMPTS[:B])).to(dev)}
    motions = {}
    cs.run_cli("edit", argv + cs.DDIM20, "probe_edit_warm_up")  # first-call costs
    order = 2 * ["route 2", "route 2 in stream order", "route 0", "route 0",
                 "route 2 in stream order", "route 2"]
    rates = {name: [] for name in routes}
    for i, name in enumerate(order):
        define, route = routes[name]
        _build._libs.pop("attention.cu", None)
        if define is not None:
            load(define)
        attention.attention_route = route
        if attention.attention_route(B, T, H, D // H, torch.float32) != expect[name]:
            raise SystemExit(f"attention_probe: {name} is not the route that runs")
        res, seconds, launches = cs.run_cli("edit", argv, f"probe_edit_{i}")
        if launches["fused_self_attention"] != 8 * cs.CLI_STEPS:
            raise SystemExit(f"attention_probe: edit on {name}: {launches}")
        motions.setdefault(name, res["motion"])
        rates[name].append(cs.CLI_SAMPLES / seconds)
        print(f"[edit] run {i + 1}, float32 attention on {name}: {seconds:.3f} s, "
              f"{cs.CLI_SAMPLES / seconds:.4f} samples/s", flush=True)
        if i < 3:
            with torch.no_grad():
                us = per_call_us(lambda: attention._launch(q, k, v, H))
            print(f"[edit]   {name}: one wrapper call at B={B} T={T} D={D} H={H}: {us:.2f} us "
                  f"of host enqueue", flush=True)
            cs.forward_host_vs_device(f"{name}: MDM f32 forward at B={B}",
                                      lambda: model(x, t, y), seconds * 1e3 / cs.CLI_STEPS)
            host_by_event(f"{name}: MDM f32 forward at B={B}", lambda: model(x, t, y))
    attention.attention_route = committed
    for name, r in rates.items():
        print(f"[edit] {name}: {len(r)} runs, median {statistics.median(r):.4f} samples/s, best "
              f"{max(r):.4f}", flush=True)
    for name in ("route 2 in stream order", "route 0"):
        diff = float(np.abs(motions["route 2"] - motions[name]).max())
        print(f"[edit] for information, max |motion(route 2) - motion({name})| over the "
              f"{cs.CLI_STEPS}-step run: {diff:.3e}", flush=True)


# --------------------------------------------------------------------------- #
# stream
# --------------------------------------------------------------------------- #
STREAM_VARIANTS = {
    "as committed": 0,
    "no scores": SCORES,
    "no P.V": PV,
    "no softmax": SOFTMAX,
    "no arithmetic": ARITHMETIC,
    "copies alone": ARITHMETIC | STORES | Q_LOADS,
}


def stream(dev):
    """The streaming route at chip_smoke.py's shapes (`cs.STREAM_SHAPES`), each part
    switched off in turn, then the pack pass alone and, for bf16 shapes that the
    kernel reads in place, the same call through the pack pass."""
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [(name, B, T, D, H, dtype) for name, B, T, D, H, types in cs.STREAM_SHAPES
             for dtype in types]
    data = {}
    for name, B, T, D, H, dtype in cases:
        n = max(2, -(-64 * 2**20 // (B * T * 3 * D * dtype.itemsize)))
        data[name, dtype] = [torch.randn((B, T, 3 * D), generator=gen, device=dev).to(
            dtype).chunk(3, dim=-1) for _ in range(n)]
    for variant, mask in STREAM_VARIANTS.items():
        load(off(mask))
        for name, B, T, D, H, dtype in cases:
            us = kernel_us(data[name, dtype], H)
            print(f"[stream] {variant:>14} | {name} {str(dtype)[6:]}: {us:8.2f} us", flush=True)
    _build._libs.pop("attention.cu", None)
    lib = _build.load_attention()
    committed = attention.stream_packs
    for name, B, T, D, H, dtype in cases:
        sets = data[name, dtype]
        planes = torch.empty((3, 2 if dtype == torch.float32 else 1, B * H, -(-T // 16) * 16,
                              -(-(D // H) // 16) * 16), device=dev, dtype=torch.bfloat16)
        stream_ = torch.cuda.current_stream(dev).cuda_stream

        def pack(q, k, v):
            lib.condmdi_attention_pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), planes.data_ptr(),
                                       B, T, H, D // H, q.stride(0), q.stride(1),
                                       attention._DTYPES[dtype][0], stream_)

        ms, _ = cs.timed_ms(pack, sets)
        line = f"[stream] pack pass alone | {name} {str(dtype)[6:]}: {ms * 1e3:8.2f} us"
        if attention.stream_reads_in_place(*sets[0], D // H):
            times = {}
            for packs in (True, False):
                attention.stream_packs = lambda *_a, packs=packs: packs
                try:
                    times[packs] = kernel_us(sets, H)
                finally:
                    attention.stream_packs = committed
            line += (f"; the whole call through the pack pass {times[True]:8.2f} us, read in place "
                     f"{times[False]:8.2f} us (the package "
                     f"{'packs' if committed(lib, *sets[0], H) else 'reads in place'})")
        print(line, flush=True)


def stream_timeline(dev):
    lib = load("CONDMDI_PROBE_STAMPS")
    lib.condmdi_probe_stamps.argtypes = [ctypes.c_void_p]
    lib.condmdi_probe_stamps.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)
    names = {1: "Q in place", 2: "tile 0 done", 29: "the last P.V done", 30: "end"}
    for j in range(1, 9):  # slots 3..26; 29 is the last P.V
        names.update({3 * j: f"tile {j} begins",
                      3 * j + 1: f"tile {j}: scores done", 3 * j + 2: f"tile {j}: P.V done"})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, B, T, D, H, types in cs.STREAM_SHAPES:
        if torch.bfloat16 not in types or not (D // H in (16, 32) or (D // H) % 64 == 0):
            continue
        sets = qkv_sets((B, T, D, H), dev, gen)
        lib.condmdi_probe_stamps(None)
        for s in sets:  # warm up, and leave the first set cold
            attention._launch(*s, H)
        stamps = torch.zeros(4 * sms * SLOTS, dtype=torch.int64, device=dev)  # CTAs an SM: < 4
        lib.condmdi_probe_stamps(stamps.data_ptr())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attention._launch(*sets[0], H)
        torch.cuda.synchronize()
        lib.condmdi_probe_stamps(None)
        d = stamps.view(-1, SLOTS).cpu().numpy()
        ctas = int((d[:, 30] > 0).sum())
        print(f"[stream_timeline] {name} B={B} T={T} D={D} H={H}: {ctas} CTAs, one call "
              f"{(time.perf_counter() - t0) * 1e6:.1f} us on the host clock; cycles since each "
              f"CTA's start, p10 / p50 / p90", flush=True)
        for slot in sorted(names):
            seen = d[:, slot] > 0
            if seen.any():
                c = sorted(d[seen, slot] - d[seen, 0])
                p = [c[min(len(c) - 1, int(f * len(c)))] for f in (0.1, 0.5, 0.9)]
                print(f"[stream_timeline]   {names[slot]:>46} ({seen.sum():3d} CTAs): "
                      f"{p[0]:7d} {p[1]:7d} {p[2]:7d}", flush=True)
    _build._libs.pop("attention.cu", None)


def shapes(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, B, T, D, H, types in cs.STREAM_SHAPES:
        for dtype in types:
            n = max(2, -(-64 * 2**20 // (B * T * 3 * D * dtype.itemsize)))
            sets = [torch.randn((B, T, 3 * D), generator=gen, device=dev).to(dtype).chunk(
                3, dim=-1) for _ in range(n)]
            label = f"{name} {str(dtype)[6:]}, route {attention.attention_route(B, T, H, D // H, dtype)}"
            try:
                us = kernel_us(sets, H)
            except (NotImplementedError, ValueError) as e:
                print(f"[shapes] {label}: refused ({e})", flush=True)
                continue
            print(f"[shapes] {label}: {us:8.2f} us; SDPA {sdpa_us(sets, (B, T, D, H)):8.2f} us",
                  flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("attention_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    modes = {"timeline": timeline, "variants": variants, "layouts": layouts, "host": host,
             "batches": batches, "edit": edit, "stream": stream, "shapes": shapes,
             "stream_timeline": stream_timeline}
    chosen = argv or list(modes)
    if any(m not in modes for m in chosen):
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if "timeline" in chosen or "stream_timeline" in chosen:
        start_build("CONDMDI_PROBE_STAMPS")
    if "variants" in chosen or "layouts" in chosen:
        for name, mask in VARIANTS.items():
            if "variants" in chosen or name in ("as committed", "no arithmetic",
                                                "K and V copies alone"):
                start_build(off(mask))
    if "edit" in chosen:
        start_build(off(F32_STREAM))
        start_build(off(NO_PDL))
    if "stream" in chosen:
        for mask in STREAM_VARIANTS.values():
            start_build(off(mask))
    print(f"[probe] {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    for m in chosen:
        modes[m](dev)
        _build._libs.pop("attention.cu", None)  # the next mode takes the committed kernel
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
