"""Where the float32 kernel routes' time goes, on one NVIDIA GPU.

    python3 resblock_probe.py [f32] [parts] [split]

With no argument it runs all three. It prints the card's name and power limit first.
It stands beside chip_smoke.py, whose timing method and inputs it uses; nothing
in the package or in chip_smoke.py needs it.

  f32     the float32 routes of the resblock half and of self-attention as the
          package builds them, per call against their plain versions and timed
          as chip_smoke.py times them, at phase 2's shapes (UNet-XL pad 200,
          B=8), phase 5's and the CLIs' (the gate UNet at B=8, UNet-XL pad 224
          at B=4; MDM edit and synthesize); the sums go to
          chiprun_out/resblock_probe_f32.json. It runs against whatever package
          stands beside it, so, copied with chip_smoke.py into an unpacked
          earlier commit, it times that commit's routes in the same call;
  parts   builds csrc/resblock.cu with -DCONDMDI_PROBE_OFF=<mask>, parts of the
          float32 kernel switched off (the results are then wrong; the times
          tell what each part costs), and times each variant at four float32
          shapes of the sampling CLIs as chip_smoke.py times them (inputs
          rotated past L2, the split weight made beforehand);
  split   the split route (the conv kernel with no cluster, then the
          normalisation kernel) at the widest halves it takes on a path, in
          builds with its parts switched off: the normalisation kernel not
          launched, and the conv kernel's pre-norm stores skipped too, so that
          the times tell what the second kernel and the scratch cost.

The probe libraries are built into the package's build directory, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs  # the timing method, the inputs and the card line
from condmdi_tpu_torch.ops import _build

SOURCE = _build.CSRC_DIR / "resblock.cu"
# csrc/resblock.cu `ProbeOff`
MMA, COPIES, SPLIT, WEIGHTS, SMALL_TERMS, NORM, SCRATCH = 1, 2, 4, 8, 16, 32, 64
VARIANTS = {
    "as committed": 0,
    "one product a tap (x_hi.w_hi)": SMALL_TERMS,
    "no wgmma": MMA,
    "no weight copies": WEIGHTS,
    "no copies": COPIES,
    "no split of x": SPLIT,
    "no copies, no split": COPIES | SPLIT,
    "no copies, no split, no wgmma": COPIES | SPLIT | MMA,
}
SPLIT_VARIANTS = {
    "as committed": 0,
    "conv kernel alone (no normalisation kernel)": NORM,
    "conv kernel alone, no pre-norm stores": NORM | SCRATCH,
}
SPLIT_SHAPES = [  # (B, T, Cin, Cout, dtype): the split route's widest halves on a path
    (4, 224, 2048, 2048, torch.float32),   # --latent_dim 1024, pad 224, the CLI's B
    (4, 112, 4096, 2048, torch.float32),
    (8, 224, 2048, 2048, torch.bfloat16),  # the same UNet served (4 requests x CFG)
    (2, 1280, 1024, 1024, torch.float32),  # UNet-XL at --unet_pad_to 1280
    (2, 1280, 1024, 1024, torch.bfloat16),
]
SHAPES = [  # (B, T, Cin, x channels, Cout, adagn, res): the CLIs' f32 halves
    (4, 28, 1024, 1024, 1024, False, True),    # UNet-XL pad 224, 64 CTAs
    (4, 112, 1024, 1024, 1024, True, False),   # 128 CTAs
    (4, 224, 1024, 1024, 1024, False, True),   # 256 CTAs in clusters of 8
    (8, 224, 128, 128, 128, True, False),      # the gate UNet: 4 groups of 16 a CTA
]


def build_all(masks) -> dict:
    """One nvcc per mask, all started together."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    jobs = {}
    for mask in masks:
        flags = [*_build.NVCC_FLAGS, f"-DCONDMDI_PROBE_OFF={mask}"]
        digest = hashlib.sha256(text.encode() + " ".join(flags).encode()).hexdigest()[:16]
        out = _build.BUILD_DIR / f"resblock_probe_{digest}.so"
        proc = None
        if not out.exists():
            proc = subprocess.Popen([_build.find_nvcc(), *flags, "-o", str(out), str(SOURCE)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[mask] = (out, proc)
    libs = {}
    for mask, (out, proc) in jobs.items():
        if proc is not None and proc.wait() != 0:
            raise SystemExit(f"resblock_probe: nvcc failed for mask {mask}:\n"
                             f"{proc.stdout.read()[-3000:]}")
        lib = ctypes.CDLL(str(out))
        _build._bind_resblock(lib)
        libs[mask] = lib
    return libs


def f32(dev):
    t0 = time.perf_counter()
    out = {"UNet-XL pad 200": cs.f32_resblock_rows("UNet-XL pad 200", cs.main_path_shapes(dev),
                                                   8, dev)}
    for name, argv, B in (("gate UNet", cs.GATE_CLI, 2 * cs.CLI_SAMPLES),
                          ("UNet-XL pad 224", cs.XL_CLI, 2 * cs.XL_CLI_SAMPLES)):
        out[name] = cs.f32_resblock_rows(name, cs.cli_resblock_shapes(argv, B, dev)[1], B, dev)
    attn = cs.f32_attention_rows(dev, cs.ATTN_SHAPES + cs.CLI_ATTENTION)
    summary = {"card": cs.card_line(), "seconds": time.perf_counter() - t0,
               "f32_resblock_ms": {k: {m: v[m] for m in ("halves", "ms", "plain_ms", "library_ms",
                                                          "bound_ms", "host_ms_per_call")}
                                   for k, v in out.items()},
               "f32_attention_ms": {r["shape"]: {m: r[m] for m in ("route", "ms", "plain_ms",
                                                                    "library_ms", "bound_ms",
                                                                    "host_ms")}
                                    for r in attn}}
    out_dir = cs.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "resblock_probe_f32.json").write_text(json.dumps(
        dict(summary, resblock_rows={k: v["rows"] for k, v in out.items()}, attention_rows=attn),
        indent=1))
    print(f"[f32] {json.dumps(summary)}", flush=True)


def parts(dev):
    from condmdi_tpu_torch.ops.resblock import PackedConvWeight, fused_conv_gn_mish

    libs = build_all(set(VARIANTS.values()))
    gen = torch.Generator().manual_seed(3)
    for B, T, cin, xc, cout, ada, res in SHAPES:
        one = 4 * (B * T * cin + cout * cin * 5)
        cases = [cs.make_case(B, T, cin, cout, ada, res, torch.float32, gen, dev, xc)
                 for _ in range(max(2, -(-64 * 2**20 // one)))]
        kin = [(*a, kw.get("scale"), kw.get("shift"), kw.get("res")) for a, kw in cases]
        caches = {a[1].data_ptr(): PackedConvWeight() for a, _ in cases}
        for a, _ in cases:
            caches[a[1].data_ptr()].get(a[1])
        print(f"[parts] f32 x[{B},{T},{xc}] Cin={cin} Cout={cout} adagn={ada} res={res}",
              flush=True)
        for name, mask in VARIANTS.items():
            _build._libs["resblock.cu"] = libs[mask]
            with torch.no_grad():
                ms, _ = cs.timed_ms(
                    lambda *z: fused_conv_gn_mish(*z, packed=caches[z[1].data_ptr()]), kin)
            print(f"[parts]   {ms * 1e3:8.2f} us  {name}", flush=True)


def split(dev):
    from condmdi_tpu_torch.ops.resblock import PackedConvWeight, fused_conv_gn_mish

    libs = build_all(set(SPLIT_VARIANTS.values()))
    gen = torch.Generator().manual_seed(4)
    for B, T, cin, cout, dtype in SPLIT_SHAPES:
        one = dtype.itemsize * (B * T * cin + cout * cin * 5)
        cases = [cs.make_case(B, T, cin, cout, True, True, dtype, gen, dev)
                 for _ in range(max(2, -(-64 * 2**20 // one)))]
        kin = [(*a, kw.get("scale"), kw.get("shift"), kw.get("res")) for a, kw in cases]
        caches = {a[1].data_ptr(): PackedConvWeight() for a, _ in cases}
        for a, _ in cases:
            caches[a[1].data_ptr()].get(a[1])
        bound, by = cs.bound_ms(B, T, cin, cout, True, True, dtype=dtype)
        print(f"[split] {str(dtype)[6:]} x[{B},{T},{cin}] Cout={cout} adagn res: bound "
              f"{bound * 1e3:.2f} us ({by})", flush=True)
        for name, mask in SPLIT_VARIANTS.items():
            _build._libs["resblock.cu"] = libs[mask]
            with torch.no_grad():
                ms, _ = cs.timed_ms(
                    lambda *z: fused_conv_gn_mish(*z, packed=caches[z[1].data_ptr()]), kin)
            print(f"[split]   {ms * 1e3:8.2f} us  {name}", flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("resblock_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    known = {"f32": f32, "parts": parts, "split": split}
    modes = argv or list(known)
    if set(modes) - set(known):
        raise SystemExit(f"resblock_probe: unknown mode(s) {sorted(set(modes) - set(known))}")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mode in sorted(modes):  # f32 first: it times the package's own build
        known[mode](dev)
        _build._libs.pop("resblock.cu", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
