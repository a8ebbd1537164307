"""Where the int8 conv kernel's time goes, on one NVIDIA GPU.

    python3 int8_probe.py [MODE ...]

MODE is parts or splits; with no argument it runs both. It prints the card's
name and power limit first. It stands beside chip_smoke.py, whose timing method
and inputs it uses; nothing in the package or in chip_smoke.py needs it.

  parts   builds csrc/quant.cu with -DCONDMDI_PROBE_OFF=<mask>, parts of the
          launch switched off (the results are then wrong; the times tell what
          each part costs), and times each variant at five shapes of the main
          path as chip_smoke.py times phase 10 (bf16, static per-tensor scale,
          inputs rotated past L2, the quantize pass included unless it is off);
  splits  builds copies of the source whose split of the K steps is capped at
          1, 2, 3, 4 or 8 parts with no other limit, beside the source as
          committed, and times each at the 16 int8 conv shapes of one UNet-XL
          int8_static forward at B=8 (the 41 convs, summed by their counts),
          in two rounds, keeping each shape's faster time.

The probe libraries are built into the package's build directory, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import torch

import chip_smoke as cs  # the timing method, the inputs and the card line
from condmdi_tpu_torch.ops import _build, quant

SOURCE = _build.CSRC_DIR / "quant.cu"
# csrc/quant.cu `ProbeOff`
MMA, STORES, SPLIT, COPIES, QUANTIZE = 1, 2, 4, 8, 16
VARIANTS = {
    "as committed": 0,
    "no quantize pass": QUANTIZE,
    "no wgmma": MMA,
    "no output stores": STORES,
    "split parts store their own sums": SPLIT,
    "no copies": COPIES,
    "no copies, no wgmma": COPIES | MMA,
    "no copies, no wgmma, no stores, no split sums": COPIES | MMA | STORES | SPLIT,
}
SHAPES = [  # (B, T, Cin, x channels, Cout, k, stride, padding)
    (8, 200, 1024, 1024, 1024, 5, 1, 2),
    (8, 25, 1024, 1024, 1024, 5, 1, 2),
    (8, 200, 526, 528, 1024, 1, 1, 0),
    (8, 200, 1024, 1024, 263, 1, 1, 0),
    (1, 128 * 197, 512, 512, 1536, 1, 1, 0),  # MDM's qkv QDense at the evaluation batch
]
SPLIT_CAPS = (1, 2, 3, 4, 8)
CAP_LINE = "constexpr int kMaxSplit = 8;"
HALF_WAVE_LINE = "while (p.split >= 4 && 2 * p.split * tiles > sm_count) --p.split;"


def build_all(sources: dict) -> dict:
    """One nvcc per (name: (source text, extra flags)), all started together."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (text, flags) in sources.items():
        flags = [*_build.NVCC_FLAGS, *flags]
        digest = hashlib.sha256(text.encode() + " ".join(flags).encode()).hexdigest()[:16]
        src = _build.BUILD_DIR / f"quant_probe_{digest}.cu"
        out = src.with_suffix(".so")
        proc = None
        if not out.exists():
            src.write_text(text)
            proc = subprocess.Popen([_build.find_nvcc(), *flags, "-o", str(out), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (out, proc)
    libs = {}
    for name, (out, proc) in jobs.items():
        if proc is not None and proc.wait() != 0:
            raise SystemExit(f"int8_probe: nvcc failed for {name}:\n{proc.stdout.read()[-3000:]}")
        lib = ctypes.CDLL(str(out))
        _build._bind_quant(lib)
        libs[name] = lib
    return libs


def time_with(lib, sets, stride, pad) -> float:
    _build._libs["quant.cu"] = lib
    with torch.no_grad():
        ms, _ = cs.timed_ms(lambda x, q: cs.int8_call(x, q, stride, pad), sets)
    return ms


def input_sets(B, T, cin, xc, cout, k, gen, dev):
    one = 2 * B * T * xc + cout * cin * k
    return [cs.int8_inputs(B, T, cin, cout, k, "static", torch.bfloat16, gen, dev, xc)
            for _ in range(max(2, -(-64 * 2**20 // one)))]


def parts(dev):
    text = SOURCE.read_text()
    libs = build_all({mask: (text, [f"-DCONDMDI_PROBE_OFF={mask}"])
                      for mask in set(VARIANTS.values())})
    gen = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, T, cin, xc, cout, k, stride, pad in SHAPES:
        sets = input_sets(B, T, cin, xc, cout, k, gen, dev)
        plan = quant.int8_plan(B, T, cin, cout, k, stride, pad, sms)
        print(f"[parts] x[{B},{T},{xc}] Cin={cin} Cout={cout} k={k} s={stride}: "
              f"{cs.plan_text(plan)}", flush=True)
        for name, mask in VARIANTS.items():
            print(f"[parts]   {time_with(libs[mask], sets, stride, pad) * 1e3:8.2f} us  {name}",
                  flush=True)


def splits(dev):
    text = SOURCE.read_text()
    if CAP_LINE not in text or HALF_WAVE_LINE not in text:
        raise SystemExit("int8_probe: csrc/quant.cu no longer holds the split's cap as expected")
    sources = {"as committed": (text, [])}
    for cap in SPLIT_CAPS:
        capped = text.replace(CAP_LINE, f"constexpr int kMaxSplit = {cap};").replace(HALF_WAVE_LINE, "")
        sources[f"at most {cap}, one wave"] = (capped, [])
    libs = build_all(sources)
    text_emb, obs, mask = cs.keyframe_inputs(8, 2)
    model = cs.build_xl(dev, torch.float32, precision_mode="int8_static")
    shapes = cs.record_int8_shapes(
        model, torch.randn(8, cs.T_FRAMES, cs.FEATS, device=dev), torch.full((8,), 500, device=dev),
        {"text_embed": text_emb.to(dev)}, dict(obs_x0=obs.to(dev), obs_mask=mask.to(dev)))
    del model
    gen = torch.Generator(device=dev).manual_seed(21)
    sets = {key: input_sets(8, key[5], key[0], key[6], key[1], key[2], gen, dev)
            for key in sorted(shapes)}
    best = {name: {} for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            for key, ss in sets.items():
                ms = time_with(lib, ss, key[3], key[4])
                best[name][key] = min(ms, best[name].get(key, ms))
    for name, times in best.items():
        total = sum(ms * shapes[key] for key, ms in times.items())
        print(f"[splits] {name}: the 41 convs {total:.4f} ms; "
              + ", ".join(f"{c}->{o} k{k} s{s} T{t} {ms * 1e3:.1f} us"
                          for (c, o, k, s, _, t, _), ms in times.items()), flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("int8_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    modes = argv or ["parts", "splits"]
    unknown = set(modes) - {"parts", "splits"}
    if unknown:
        raise SystemExit(f"int8_probe: unknown mode(s) {sorted(unknown)}")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    try:
        for mode in modes:
            {"parts": parts, "splits": splits}[mode](dev)
    finally:
        _build._libs.pop("quant.cu", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
