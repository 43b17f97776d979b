"""Probe: where K3's time goes (``csrc/extract_rot.cu``), on the card.

Builds variants of the kernel source with one leg taken out, by text
substitution into the build directory (none is kept in the repository), and
times each mode's variants at the rotated tracer's shape (B = 512 agents,
16^3 patches, a 256^3 volume, the draws of ``chip_smoke.py::k3_cases``):

- ``full``: the source as it is;
- ``stage``: staging only (the box copied and waited for, no blend);
- ``blend``: the blend only, from a window zeroed once per block (so no
  value is read that nothing wrote);
- ``blend_nc``: the blend only, each lane's corner reads moved to its own
  32-bit word, so a warp's shared loads meet no bank conflict (the address
  arithmetic stays, multiplied by a zero the compiler cannot see);
- ``full_nc``: the whole kernel with those conflict-free reads;
- ``minb3``: the whole kernel with ``__launch_bounds__(THREADS, 3)``;
- ``batch4``, ``batch16``: the bf16 mode's staging batch (``kStageBatch``,
  8) changed;
- ``empty``: neither staging nor blend (a block's fixed cost);
- ``nonext``: the bf16 mode's staging without the next piece's first
  value (its pairs wrong: the cost of those loads);
- ``cg``: the bf16 mode's pieces loaded past L1 (``ld.global.cg``).

Each variant runs in both modes (float32, bf16). Every variant that keeps
both legs and the reads (``full``, ``minb3``, the batches, ``cg``) is
checked against the
package's own kernel bit for bit. Times: CUDA events around replays of a
CUDA graph of 20 launches, all variants in turns (in order, then in
reverse), ``ROUNDS`` times; the median and the best are reported.
Beside them: ptxas's registers and spills per instance and the blocks a
multiprocessor holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at
the launch's window size).

``python -m elektronn2_tpu_torch.scripts.exp_k3_legs --banks`` runs on the
CPU instead: for the same agents it counts the shared-memory wavefronts a
warp's corner loads take (``bank_wavefronts``) in the float32 window, the
former bf16 window (rows of bf16 values) and the pair window.

Usage, on the card: ``python -m elektronn2_tpu_torch.scripts.exp_k3_legs``
(one JSON line per row). Set ``K3_LEGS`` (comma-separated names) to build
fewer variants, and ``K3_ALT`` to the path of another ``extract_rot.cu``
(an earlier form, from a ``git archive`` of its commit) to time its
variants of the same names (or of ``K3_ALT_LEGS``), prefixed ``alt_``, in
the same turns. Without a CUDA device it raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess

import numpy as np
import torch

from ..data.tracing_utils import flight_frame
from ..ops import extract_rot
from ..utils.cuda_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc

SEED = 12                         # chip_smoke.py: SEED + 12
VOL = (1, 256, 256, 256)
B = 512
PATCH = (16, 16, 16)
POS_RANGE = (24, 232)
LAUNCHES = 20                     # launches in one captured graph
ROUNDS = 5

#: probe number of each variant (``K3_PROBE`` in the variant source), its
#: ``__launch_bounds__`` minimum of blocks and further (old, new) text
#: substitutions (the bf16 mode's staging batch, next-value loads and load
#: path tried against the source's)
VARIANTS = {"full": (0, 2, []), "stage": (1, 2, []), "blend": (2, 2, []),
            "blend_nc": (3, 2, []), "full_nc": (4, 2, []),
            "minb3": (0, 3, []),
            "batch4": (0, 2, [("kStageBatch = 8;", "kStageBatch = 4;")]),
            "batch16": (0, 2, [("kStageBatch = 8;", "kStageBatch = 16;")]),
            "empty": (5, 2, []),
            "nonext": (6, 2, [("const bool next = 8 * c + 7 <= s + ny - 2;",
                               "const bool next = false;")]),
            "t512b4": (0, 2, [("constexpr int THREADS = 256;",
                               "constexpr int THREADS = 512;"),
                              ("kStageBatch = 8;", "kStageBatch = 4;")]),
            "t512b2": (0, 2, [("constexpr int THREADS = 256;",
                               "constexpr int THREADS = 512;"),
                              ("kStageBatch = 8;", "kStageBatch = 2;")]),
            "cg": (0, 2, [("return __ldg(reinterpret_cast<const uint4*>(p));",
                           "return __ldcg(reinterpret_cast<const uint4*>(p));"
                           )])}

_HEAD = "#ifndef K3_PROBE\n#define K3_PROBE 0\n#endif\n"

def _zero_fill(indent, words):
    return (f"#if K3_PROBE == 2 || K3_PROBE == 3\n"
            f"{indent}for (int k = threadIdx.x; k < {words}; k += THREADS)\n"
            f"{indent}  reinterpret_cast<uint4*>(win)[k] = "
            f"make_uint4(0u, 0u, 0u, 0u);\n#elif K3_PROBE == 5\n#else\n")


_BF16_BLEND = ("    mine = a.interior ? blend_pairs<true>(win, vc, o, a, g, "
               "par)\n                      : blend_pairs<false>(win, vc, o, "
               "a, g, par);\n")
_BF16_STAGE = ('    if (a.staged) {\n'
               "      // the last row's pieces end last: its aligned start, its pieces and\n"
               '      // the value after them\n'
               '      const __nv_bfloat16* last = box_origin(vc, a, g)\n'
               '          + (a.ext[0] - 1) * ((int64_t)g.X * g.Y)\n'
               '          + (int64_t)(a.ext[1] - 1) * g.Y;\n'
               '      if (last - row_shift(last) + 8 * ((a.ext[2] + 13) / 8) + 2 <= g.end)\n'
               '        stage_pairs<kAligned, true>(win, vc, a, g, par);\n'
               '      else\n'
               '        stage_pairs<kAligned, false>(win, vc, a, g, par);\n'
               '    }\n')
_F32_READ = "      const T* r00 = win + (lz * ex + lx) * rp + ly;\n"
_BF16_READ = ("        const uint32_t* r = win + lz * RZ + lx * RX + ly + "
              "par;\n")

#: text substitutions into ``csrc/extract_rot.cu``: groups of (old, new)
#: alternatives, the first whose ``old`` the source holds taken (the source
#: as it is, and the float32-only body of its form before the pair window);
#: a group marked optional may match nothing
SUBS = [
    (False, [("  const T* end;        // the end of the volume, never read\n",
              "  int zero;\n  const T* end;        // the end of the "
              "volume, never read\n")]),
    (False, [("  g.cap = cap & ~(kPer<T> - 1);",
              "  g.cap = cap & ~(kPer<T> - 1);\n  g.zero = 0;")]),
    (False, [("__global__ void __launch_bounds__(THREADS, 2)",
              "__global__ void __launch_bounds__(THREADS, K3_MINB)")]),
    # the staging leg of each body
    (False, [("    if (a.staged) stage_box(win, vc, a, g);\n",
              _zero_fill("    ", "g.cap / kPer<T>")
              + "    if (a.staged) stage_box(win, vc, a, g);\n#endif\n"),
             ("  if (a.staged) stage_box(win, vc, a, g);\n",
              _zero_fill("  ", "g.cap / kPer<T>")
              + "  if (a.staged) stage_box(win, vc, a, g);\n#endif\n")]),
    (True, [(_BF16_STAGE, _zero_fill("    ", "g.cap / 4") + _BF16_STAGE
             + "#endif\n"),
            ("    if (a.staged) stage_pairs<kAligned>(win, vc, a, g, par);\n",
             _zero_fill("    ", "g.cap / 4")
             + "    if (a.staged) stage_pairs<kAligned>(win, vc, a, g, par);"
               "\n#endif\n")]),
    # the blend leg of each body
    (False, [("    mine = a.interior\n",
              "#if K3_PROBE == 1 || K3_PROBE == 5\n    mine = 1;\n"
              "    (void)box; (void)t0; (void)st;\n#else\n"
              "    mine = a.interior\n"),
             ("  const int mine =\n      a.interior\n",
              "#if K3_PROBE == 1 || K3_PROBE == 5\n  const int mine = 1;\n"
              "  (void)box; (void)o; (void)t0; (void)st;\n#else\n"
              "  const int mine =\n      a.interior\n")]),
    (False, [("blend_box<T, false, kAligned>(win, vc, box, o, a, g, t0, "
              "st);\n",
              "blend_box<T, false, kAligned>(win, vc, box, o, a, g, t0, st);"
              "\n#endif\n")]),
    (True, [(_BF16_BLEND,
             "#if K3_PROBE == 1 || K3_PROBE == 5\n    mine = 1;\n#else\n"
             + _BF16_BLEND + "#endif\n")]),
    # conflict-free reads
    (False, [(_F32_READ,
              "#if K3_PROBE == 3 || K3_PROBE == 4\n"
              "      const T* r00 = win + ((lz * ex + lx) * rp + ly)"
              " * g.zero\n"
              "                     + (4 / sizeof(T)) * (threadIdx.x & 31);\n"
              "#else\n" + _F32_READ + "#endif\n")]),
    (True, [(_BF16_READ,
             "#if K3_PROBE == 3 || K3_PROBE == 4\n"
             "        const uint32_t* r = win + (lz * RZ + lx * RX + ly + par)"
             " * g.zero\n                            + (threadIdx.x & 31);\n"
             "#else\n" + _BF16_READ + "#endif\n")]),
]

_OCCUPANCY = """
extern "C" int e2t_probe_occupancy(int smem_f32, int smem_bf16, int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, rotated_patches_kernel<float, true>, THREADS, smem_f32);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, rotated_patches_kernel<__nv_bfloat16, true>, THREADS,
        smem_bf16);
  return static_cast<int>(e);
}
"""

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(log):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)} of
    the rotated-patch instances in an ``-Xptxas -v`` log."""
    out, fn, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _PTXAS_REGS.search(line)
        if m and fn and "rotated_patches_kernel" in fn:
            mode = "bf16" if "bfloat16" in fn else "f32"
            aligned = "Lb1E" in fn
            out[f"{mode}_{'aligned' if aligned else 'ragged'}"] = (
                int(m.group(1)),) + spill
    return out


def start_build(name):
    """Write variant ``name``'s source (``alt_<variant>``: from ``K3_ALT``)
    and start its nvcc; returns ``(process, library path, the form of its
    bf16 entry (``load_variant``))``."""
    src_path = os.path.join(CSRC_DIR, "extract_rot.cu")
    if name.startswith("alt_"):
        src_path = os.environ["K3_ALT"]
    probe, minb, extra = VARIANTS[name.removeprefix("alt_")]
    with open(src_path) as f:
        text = f.read()
    for optional, alternatives in SUBS + [(False, [e]) for e in extra]:
        for old, new in alternatives:
            if old in text:
                text = text.replace(old, new)
                break
        else:
            if not optional:
                raise RuntimeError(f"variant {name}: none of "
                                   f"{[o for o, _ in alternatives]!r} in "
                                   "extract_rot.cu")
    text = _HEAD + text + _OCCUPANCY
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, f"extract_rot_legs_{name}.cu")
    so = os.path.join(BUILD_DIR, f"libextract_rot_legs_{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, f"-DK3_PROBE={probe}", f"-DK3_MINB={minb}",
         "-I", CSRC_DIR, "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so, 1 if "int row_words" in text else 0


def load_variant(so, form):
    """Load a variant's library; ``form``: what its bf16 entry takes after
    ``cap`` (0: nothing, the rows of bf16 values; 1: the pair window's two
    pitches)."""
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.e2t_rotated_patches_init.argtypes = [P]
    lib.e2t_probe_occupancy.argtypes = [I, I, P]
    lib.e2t_rotated_patches_f32.argtypes = [P] * 6 + [I] * 9 + [P]
    lib.e2t_rotated_patches_bf16.argtypes = [P] * 6 + [I] * (9 + 2 * form) \
        + [P]
    optin = ctypes.c_int(0)
    if lib.e2t_rotated_patches_init(ctypes.byref(optin)) != 0:
        raise RuntimeError(f"{so}: init failed")
    return lib


def tracer_case():
    """The rotated tracer's case of ``chip_smoke.py::k3_cases`` (the same
    numpy draws)."""
    rng = np.random.RandomState(SEED)
    vol = torch.from_numpy(rng.rand(*VOL).astype(np.float32)).cuda()
    h = rng.randn(B, 3)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    pos = torch.from_numpy(
        rng.uniform(*POS_RANGE, (B, 3)).astype(np.float32)).cuda()
    F = flight_frame(torch.from_numpy(h.astype(np.float32)).cuda())
    return vol, pos, F


def launcher(fn, vol, pos, F, out, ok, stats, cap, pitches=()):
    f, Z, X, Y = vol.shape

    def go():
        err = fn(vol.data_ptr(), pos.data_ptr(), F.data_ptr(),
                 out.data_ptr(), ok.data_ptr(), stats.data_ptr(), B, f, Z, X,
                 Y, *PATCH, cap, *pitches,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return go


def graph_of(fn):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(g, stream=side):
        for _ in range(LAUNCHES):
            fn()
    return g


def replay_us(g):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return 1e3 * e0.elapsed_time(e1) / LAUNCHES


def bank_wavefronts(layout):
    """Mean shared-memory wavefronts of a warp's corner loads, per
    warp-sample, for the tracer case's agents (``tracer_case``'s draws,
    numpy only): a warp is 32 consecutive samples (two rows of 16 along the
    patch's y at one z), a load's wavefronts the most distinct 32-bit words
    that fall on one of the 32 banks. ``layout``: "f32" (rows of
    ``row_values(ey)`` floats, 8 loads a sample), "bf16_rows" (the former
    bf16 window: rows of ``row_values(ey, 2)`` values, 8 two-byte loads) or
    "pairs" (the pair window of ``pair_pitches``, 4 loads). Each row's shift
    within its 16-byte piece is the box's y start's."""
    rng = np.random.RandomState(SEED)
    rng.rand(int(np.prod(VOL)))                    # the volume's draws
    h = rng.randn(B, 3)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    pos = rng.uniform(*POS_RANGE, (B, 3)).astype(np.float32)
    F = flight_frame(torch.from_numpy(h.astype(np.float32))).numpy()
    half = (np.asarray(PATCH, np.float64) - 1) / 2
    o = [np.arange(p) - hp for p, hp in zip(PATCH, half)]
    iz, ix, iy = (g.ravel() for g in np.meshgrid(*o, indexing="ij"))
    row, plane, _ = extract_rot.pair_pitches(PATCH, VOL)
    total = warps = 0
    for b in range(B):
        fr, p0 = F[b].astype(np.float64), pos[b].astype(np.float64)
        c = p0[:, None] + fr[0][:, None] * iz + fr[1][:, None] * ix \
            + fr[2][:, None] * iy
        t = np.abs(fr).T @ half
        lo = np.floor(p0 - t - 2.0 ** -20 * (np.abs(p0) + t))
        hi = np.floor(p0 + t + 2.0 ** -20 * (np.abs(p0) + t)) + 1
        ext = (hi - lo + 1).astype(int)
        lz, lx, ly = (np.floor(c) - lo[:, None]).astype(int).reshape(
            3, -1, 32)
        s = int(lo[2]) % 8
        if layout == "pairs":
            loads = [(lz + dz) * plane + (lx + dx) * row + ly + (s & 1)
                     for dz in (0, 1) for dx in (0, 1)]
        else:
            elem = 4 if layout == "f32" else 2
            rv = extract_rot.row_values(ext[2], elem)
            shift = s % (16 // elem)
            loads = [(((lz + dz) * ext[1] + lx + dx) * rv + ly + dy + shift)
                     * elem // 4
                     for dz in (0, 1) for dx in (0, 1) for dy in (0, 1)]
        for words in loads:
            for w in words:
                u = np.unique(w)
                total += np.bincount(u % 32, minlength=32).max()
        warps += lz.shape[0]
    return total / warps


def main():
    """Build, check and time every variant; returns one dict per row."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_k3_legs runs on the card only "
                           "(torch.cuda.is_available() is false)")
    names = [n for n in os.environ.get("K3_LEGS", ",".join(VARIANTS))
             .split(",") if n]
    if os.environ.get("K3_ALT"):
        names += [f"alt_{n}" for n in os.environ.get("K3_ALT_LEGS", ",".join(
            names)).split(",") if n]
    builds = {n: start_build(n) for n in names}
    vol, pos, F = tracer_case()
    vb = vol.to(torch.bfloat16).contiguous()
    ref = {"f32": extract_rot.rotated_patches(vol, pos, F, PATCH),
           "bf16": extract_rot.rotated_patches_bf16(vb, pos, F, PATCH)}
    cap32 = extract_rot.window_values(vol.device, PATCH, vol.shape)
    pair_cap = extract_rot.window_values(vol.device, PATCH, vol.shape,
                                         torch.bfloat16)
    pitches = extract_rot.pair_pitches(PATCH, vol.shape)[:2]
    # the former bf16 window: rows of bf16 values (2 bytes a slot)
    edge = extract_rot.box_edge(PATCH)
    rows16 = min(edge * edge * extract_rot.row_values(edge, 2),
                 extract_rot.shared_optin(
                     extract_rot._fns.e2t_rotated_patches_init, vol.device)
                 // 2) // 8 * 8
    rows, graphs = [], {}
    for name in names:
        proc, so, form = builds[name]
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = load_variant(so, form)
        caps = {"f32": (cap32, 4, ()),
                "bf16": [(rows16, 2, ()), (pair_cap, 4, pitches)][form]}
        occ = (ctypes.c_int * 2)()
        if lib.e2t_probe_occupancy(4 * cap32,
                                   caps["bf16"][1] * caps["bf16"][0], occ):
            raise RuntimeError(f"variant {name}: occupancy query failed")
        regs = ptxas_report(log)
        for mode, v, fn in (("f32", vol, lib.e2t_rotated_patches_f32),
                            ("bf16", vb, lib.e2t_rotated_patches_bf16)):
            out = torch.empty((B, 1, *PATCH), device="cuda")
            ok = torch.empty((B,), dtype=torch.bool, device="cuda")
            stats = torch.zeros(2, dtype=torch.int64, device="cuda")
            cap, slot, pit = caps[mode]
            go = launcher(fn, v, pos, F, out, ok, stats, cap, pit)
            go()
            torch.cuda.synchronize()
            unstaged, staged = stats.tolist()
            row = dict(probe="k3_legs", variant=name, mode=mode,
                       registers={k: r[0] for k, r in regs.items()
                                  if k.startswith(mode)},
                       spill_bytes={k: r[1] + r[2] for k, r in regs.items()
                                    if k.startswith(mode)},
                       blocks_per_sm=occ[0 if mode == "f32" else 1],
                       window_bytes=slot * cap,
                       unstaged=unstaged,
                       staged_bytes=(4 if mode == "f32" else 2) * staged)
            if VARIANTS[name.removeprefix("alt_")][0] == 0:
                row["equals_package_kernel"] = bool(
                    torch.equal(out, ref[mode][0])
                    and torch.equal(ok, ref[mode][1]))
                if not row["equals_package_kernel"]:
                    raise AssertionError(f"variant {name} ({mode}) differs "
                                         "from the package's kernel")
            graphs[(name, mode)] = graph_of(go)
            rows.append(row)
    keys = list(graphs)
    times = {k: [] for k in keys}
    for _ in range(ROUNDS):
        for k in keys + keys[::-1]:
            times[k].append(replay_us(graphs[k]))
    for row in rows:
        t = times[(row["variant"], row["mode"])]
        row.update(us_median=statistics.median(t), us_best=min(t),
                   us_worst=max(t), windows=len(t),
                   timing=f"CUDA events around replays of a graph of "
                          f"{LAUNCHES} launches, all variants in turns")
    return rows


if __name__ == "__main__":
    import sys
    if "--banks" in sys.argv[1:]:
        for layout in ("f32", "bf16_rows", "pairs"):
            print(json.dumps(dict(probe="k3_banks", layout=layout,
                                  wavefronts_per_warp_sample=bank_wavefronts(
                                      layout))), flush=True)
    else:
        for row in main():
            print(json.dumps(row), flush=True)
