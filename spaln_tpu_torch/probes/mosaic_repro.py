"""The growing skeletons of the slab kernel's step on the card: the H100
counterpart of scripts/mosaic_repro.py.

    python -m spaln_tpu_torch.probes.mosaic_repro [level ...]
                                     [--B B] [--sop8] [--chunks 7]
                                     [--device cuda|cpu]

The script's ``build(level)`` makes one of three pallas_calls (level 50:
mosaic_repro.py:93; levels 32 and up: 265; the others: 449); each level
adds one piece of the slab step to a bare loop of Tpad = 896 steps (7
chunks of 128) over an (8, 128) int32 carry per block of GRP = 8 rows,
and emits lane 127 of each step into four (B, Tpad) outputs:

  0, 13-29  h = h1 + 1 (the bare skeleton)
  1         + the operand read: tiles q, q+1 of the stack, the 256-wide
            pair rotated by -r, rows of sub-tiles 0, 3, 4
  2         + the fills value at lane t2, shift_right of h1 and h2, the
            band-edge, column-0 and top-of-band selects
  3         2 + the active mask
  4         3 + the row and rc reductions (lanes li and rcl)
  5         + the one-hot score over the 5 classes (a static tile)
  6         1 + 5
  7         + a roll of one tile; 8: + tile q, no roll
  9         + the static tile 3; 10: + tile q; 11: + the static fills
            tile 2; 12: the operand read as 1, sub-tiles 0 and 3
  30, 31    9, with the emissions dropped (30) and the final h1 over
            lanes 0..127 of the first output
  32-38     the level >= 32 kernel (whole-array blocks, B = GRP only):
            32 no emission, 33-35 (and 39, 47-49, 51 and up) the
            emission, 35 the final h1 into the fourth output, 36 one
            loop of all steps, 37 no tile read, 38 a 384-wide window of
            three tiles a chunk
  40-46     one loop of all steps with the operand read at 1028 - t,
            the fills tile of the step's chunk and the stores at the
            chunk's last step (41: no read; 42: no fills; 44: the NEV
            tile computed; 45: stores every step; 46: the first output
            only)
  50        the chunk as a grid axis with the carry in scratch: here one
            loop over the chunks, the carry in registers

Levels 1-4 and 6-8 read the stack tile as (SOP, GRP, 128) and the fills
block as (3, GRP, CHUNK), the layout they were written for; the script's
BlockSpecs hand them 2-D blocks (ROADMAP.md Queue 3), and these versions
compute what the script computes with those reads viewed in 3-D.  Levels
32-46 take B = GRP = 8: the script's whole-array blocks store one (8,
128) block a program, and any other B raises here; without --B each
level runs at its script_B (REPRO_B's 16, or GRP at levels 32-46), so
the default command line runs every level.

Each level has a plain PyTorch version (``plain``) and an instance of
skeleton_kernel<LEVEL> in csrc/mosaic_repro.cu (``run``: the kernel for
CUDA tensors, the plain version for CPU ones).  Memory the TPU kernel
never writes (levels 36 and 46 leave parts of the outputs alone) holds
UNWRITTEN = 2**31 - 1 in both, as Pallas's interpret mode fills it.
REPRO_B becomes --B and REPRO_SOP8 --sop8 (stack tiles of 8 GRP rows, of
which a level reads the first 7 GRP); REPRO_FULLSPEC changes only the
TPU's BlockSpecs and has no counterpart.  --chunks sets Tpad = 128 x
chunks (7, the script's, by default) so that ns a step comes from
T-differencing: (t(2 chunks) - t(chunks)) / (128 chunks).  Prints one
line a level: PASS (built, launched and equal to its plain version; on
the CPU the plain version ran) or FAIL with the reason, ms at --chunks
and ns a step.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import numpy as np
import torch

from ..ops.dp_spliced_cuda import CSRC, _check, _launch, _ptr, build_library
from ._cuda import elapsed_ms

SOURCE = CSRC / "mosaic_repro.cu"
ENTRY = "mosaic_repro"
GRP, L, CHUNK = 8, 128, 128
NBT, SOP, NCLASS = 12, 7, 5
N_CHUNKS = 7
NEV = -(2**31 // 16 * 7)
LTREPRO = 128
UNWRITTEN = 2**31 - 1
I32 = torch.int32
REPLACES = {"default": "scripts/mosaic_repro.py:449",
            "whole": "scripts/mosaic_repro.py:265",
            "chunk_grid": "scripts/mosaic_repro.py:93"}
# every level the script distinguishes: one kernel instance each
LEVELS = tuple(range(13)) + tuple(range(30, 39)) + tuple(range(40, 47)) \
    + (50,)
# the int32 operations a step of each level's result needs, an element
# (the lanes that reach an output: lane 127 where only the emission
# does, all 128 where the final carry or a shift does), counted from its
# body; step-invariant terms (a static tile, the one-hot score, dl) are
# counted once
OPS = {0: (1, 1), 1: (1, 4), 2: (L, 15), 3: (L, 24), 4: (L, 30),
       5: (1, 2), 6: (1, 5), 7: (1, 3), 8: (1, 3), 9: (1, 2), 10: (1, 3),
       11: (1, 2), 12: (1, 3), 30: (L, 2), 31: (L, 2), 32: (L, 2),
       33: (L, 2), 34: (L, 2), 35: (L, 2), 36: (L, 2), 37: (L, 1),
       38: (1, 4), 40: (1, 4), 41: (1, 1), 42: (1, 3), 43: (1, 4),
       44: (1, 4), 45: (1, 4), 46: (1, 4), 50: (1, 5)}
launches: dict[str, int] = {}


def instance(level: int) -> int:
    """The kernel instance a level runs: what the script's build(level)
    makes of it (13-29 are level 0's body; 39, 47-49 and 51 and up the
    level >= 32 kernel's default branches, as 33)."""
    if level == 50:
        return 50
    if level >= 32:
        return level if level in LEVELS else 33
    return level if level in LEVELS else 0


def kernel_of(level: int) -> str:
    """Which of the script's three pallas_calls the level's build is."""
    lev = instance(level)
    return ("chunk_grid" if lev == 50 else "whole" if lev >= 32
            else "default")


def script_B(level: int) -> int:
    """The B the script runs the level at: REPRO_B's 16, or GRP where the
    level >= 32 kernel's whole-array blocks need it."""
    return GRP if kernel_of(level) == "whole" else 16


def check_level(level: int, B: int, chunks: int) -> None:
    """What the skeletons cannot take, as ValueError."""
    if B < GRP or B % GRP:
        raise ValueError(f"B={B}: a multiple of GRP={GRP}")
    if chunks < 1:
        raise ValueError(f"chunks={chunks}: at least 1")
    if kernel_of(level) == "whole" and B != GRP:
        raise ValueError(f"level {level}: the script's level >= 32 kernel "
                         f"has whole-array blocks, so each of its "
                         f"programs stores one ({GRP}, {CHUNK}) block: "
                         f"B must be GRP = {GRP}, not {B}")
    if instance(level) == 11 and chunks < 3:
        raise ValueError("level 11 reads the third fills tile of its "
                         "block: chunks >= 3")
    if instance(level) == 35 and chunks < 2:
        raise ValueError("level 35 writes the second chunk of its fourth "
                         "output: chunks >= 2")


def inputs(B: int = 16, chunks: int = N_CHUNKS, sop8: bool = False,
           seed: int = 0) -> dict:
    """The script's inputs, as its main draws them from numpy's
    default_rng(seed) (fills of ``chunks`` tiles a block; the script's
    7 by default): ``args`` of every level but 50 and ``args50``."""
    rng = np.random.default_rng(seed)
    nblk = B // GRP
    sca = np.asarray([1, -256, 900, 0, 1, 0, 0, 0], np.int32)

    def mk(*s):
        return rng.integers(-3, 3, s).astype(np.int32)
    args = dict(sca=sca, dl=mk(B, L), nb=mk(B, L) + 100, mb=mk(B, L) + 90,
                ec=mk(B, L), colm=mk(B, L), colm1=mk(B, L),
                qp=mk(NCLASS, B, L),
                stk=mk(nblk * NBT, (8 if sop8 else SOP) * GRP, 128),
                fills=mk(nblk * chunks, 3 * GRP, CHUNK))
    args50 = dict(sca=sca, dl=mk(B, L), stk=mk(nblk * NBT, SOP * GRP, 128),
                  fills=mk(chunks, 3, B, CHUNK))
    return {"args": args, "args50": args50}


def level_inputs(level: int, inp: dict, device) -> dict:
    """The tensors a level takes, on ``device``."""
    a = inp["args50"] if instance(level) == 50 else inp["args"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in a.items()}


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (XLA's int32 sums wrap)."""
    return ((x + 2**31) % 2**32 - 2**31).to(I32)


def _outputs(B: int, chunks: int, device) -> list:
    return [torch.full((B, CHUNK * chunks), UNWRITTEN, dtype=I32,
                       device=device) for _ in range(4)]


def _tiles(stk: torch.Tensor, nblk: int) -> torch.Tensor:
    """The stack as (blocks, NBT, tile rows, 128)."""
    return stk.reshape(nblk, NBT, stk.shape[1], 128)


def _sub(tile: torch.Tensor, s: int) -> torch.Tensor:
    """Rows s*GRP .. s*GRP+7 of (blocks, rows, cols) tiles, as (B, cols)."""
    return tile[:, s * GRP:(s + 1) * GRP].reshape(-1, tile.shape[-1])


def plain(level: int, a: dict, chunks: int = N_CHUNKS) -> list:
    """The plain PyTorch version of ``level`` on the tensors ``a``
    (level_inputs): its four (B, 128 chunks) int32 outputs."""
    lev = instance(level)
    B = a["dl"].shape[0]
    check_level(level, B, chunks)
    if lev == 50:
        return _plain50(a, chunks)
    if lev >= 32:
        return _plain_whole(lev, a, chunks)
    return _plain_default(lev, a, chunks)


def _plain_default(lev: int, a: dict, chunks: int) -> list:
    """mosaic_repro.py:189-449: a grid of B/GRP blocks, each a fori over
    the chunks of a fori over 128 steps."""
    dev = a["dl"].device
    B = a["dl"].shape[0]
    nblk = B // GRP
    m0, lw0, base0 = (int(a["sca"][i]) for i in (0, 1, 2))
    lanes = torch.arange(L, device=dev, dtype=I32)[None]
    dl, Nb, Mb = a["dl"], a["nb"], a["mb"]
    dln = dl - lanes
    mrow = m0 + lanes
    m_ok = (mrow >= 1) & (mrow <= Mb)
    li = (Mb - m0).clamp(0, L - 1)
    tiles = _tiles(a["stk"], nblk)
    fills = a["fills"].reshape(nblk, chunks, 3 * GRP, CHUNK)
    cst = torch.zeros((B, L), dtype=I32, device=dev)
    if lev in (5, 6):                      # one-hot score, a static tile
        code = tiles[:, 3, 0].repeat_interleave(GRP, 0)          # (B, L)
        for k in range(NCLASS):
            cst = cst + torch.where(code == k, a["qp"][k], 0)
    if lev in (9, 30, 31):
        cst = cst + _sub(tiles[:, 3], 0) + _sub(tiles[:, 3], 3)
    if lev == 11:
        cst = cst + _sub(fills[:, 2], 0)
    out = _outputs(B, chunks, dev)
    h1 = torch.full((B, L), NEV, dtype=I32, device=dev)
    h2 = h1.clone()
    bidx = torch.arange(B, device=dev)
    for c in range(chunks):
        em = [torch.full((B, CHUNK), NEV, dtype=I32, device=dev)
              for _ in range(4)]
        for t2 in range(CHUNK):
            t = c * CHUNK + t2
            sc = m0 + lw0 + 1 + t
            n = sc + dln
            r_off = t - 2 * lanes
            active = ((r_off >= 0) & (r_off < 512) & (n >= 1) & (n <= Nb)
                      & m_ok)
            first = r_off == 0
            h_out = h1 + 1 + cst
            if lev in (1, 6, 7, 8, 10, 12):
                bq = min(max(base0 - t + 128, 0), NBT * 128 - 256)
                q, r = bq // 128, bq % 128
                pair = torch.cat([tiles[:, q], tiles[:, q + 1]], dim=-1)
            if lev in (1, 6):
                for s in (0, 3, 4):
                    h_out = h_out + _sub(pair, s)[:, r:r + L]
            if lev == 12:
                for s in (0, 3):
                    h_out = h_out + _sub(pair, s)[:, r:r + L]
            if lev == 7:
                for s in (0, 3):
                    h_out = h_out + torch.roll(_sub(tiles[:, q], s), -r, 1)
            if lev in (8, 10):
                for s in (0, 3):
                    h_out = h_out + _sub(tiles[:, q], s)
            if 2 <= lev <= 4:
                fv = [_sub(fills[:, c], s)[:, t2] for s in (0, 1)]
                up_h = torch.cat([fv[1][:, None], h1[:, :-1]], 1)
                diag_h = torch.cat([fv[0][:, None], h2[:, :-1]], 1)
                edge = first & (n != 1)
                left_h = torch.where(n == 1, a["colm"], torch.where(
                    edge, a["ec"], torch.where(first, NEV, h1)))
                diag_h = torch.where(n == 1, a["colm1"], diag_h)
                up_h = torch.where(r_off >= 512 - 1, NEV, up_h)
                h_out = h_out + up_h + diag_h + left_h
            if 3 <= lev <= 4:
                h_out = torch.where(active, h_out, NEV)
            em[0][:, t2] = h_out[:, L - 1]
            em[1][:, t2] = h_out[:, L - 1]
            if lev == 4:
                em[2][:, t2] = _wrap(torch.where(lanes == li, h_out, 0)
                                     .long().sum(1))
                rcl = (sc + dl[:, 0] - Nb[:, 0]).long()
                inb = (rcl >= 0) & (rcl < L)
                em[3][:, t2] = torch.where(
                    inb, h_out[bidx, rcl.clamp(0, L - 1)], 0)
            h1, h2 = h_out, h1
        if lev == 30:
            em = [e.fill_(NEV) for e in em]
        for o, e in zip(out, em):
            o[:, c * CHUNK:(c + 1) * CHUNK] = e
    if lev in (30, 31):
        out[0][:, :CHUNK] = h1[:, :CHUNK]
    return out


def _plain_whole(lev: int, a: dict, chunks: int) -> list:
    """mosaic_repro.py:123-273: one program over whole arrays (B =
    GRP)."""
    dev = a["dl"].device
    stk, fills = a["stk"], a["fills"]
    wS = stk[3, 0:GRP] + stk[3, 3 * GRP:4 * GRP]
    out = _outputs(GRP, chunks, dev)
    negv = torch.full((GRP, L), NEV, dtype=I32, device=dev)
    enegv = torch.full((GRP, CHUNK), NEV, dtype=I32, device=dev)
    h1, h2 = negv.clone(), negv.clone()
    base0v = 900 + LTREPRO

    def window(t):                        # the pair at 1028 - t, rotated
        bq = min(max(base0v - t, 0), NBT * 128 - 256)
        q, rr = bq // 128, bq % 128
        wide = torch.cat([stk[q], stk[q + 1]], dim=1)[:, rr:rr + L]
        return wide[0:GRP] + wide[3 * GRP:4 * GRP]

    def store(c, *vals):
        for o, v in zip(out, vals):
            o[:, c * CHUNK:(c + 1) * CHUNK] = v

    if lev in (40, 41, 42, 43, 44, 45, 46):
        ebh = enegv.clone()
        for t in range(chunks * CHUNK):
            t2, c = t % CHUNK, t // CHUNK
            h_out = h1 + 1
            if lev in (40, 42, 43, 44, 45, 46):
                h_out = h_out + window(t)
            if lev in (40, 43, 44, 45, 46):
                h_out = h_out + fills[min(c, chunks - 1), 0:GRP]
            ebh[:, t2] = h_out[:, L - 1]
            if lev == 45 or t2 == CHUNK - 1:
                if lev == 46:
                    store(c, ebh)
                else:
                    store(c, ebh, ebh, enegv, enegv)
            h1, h2 = h_out, h1
        return out
    if lev == 38:
        for c in range(chunks):
            fl = fills[min(c, chunks - 1), 0:GRP]
            q0 = min(max((base0v - (c + 1) * CHUNK + 1) // 128, 0),
                     NBT - 3)
            wide = torch.cat([stk[q0], stk[q0 + 1], stk[q0 + 2]], dim=1)
            ebh = enegv.clone()
            for t2 in range(CHUNK):
                t = c * CHUNK + t2
                rr = min(max(base0v - t - q0 * 128, 0), 255)
                w = wide[:, rr:rr + L]
                h_out = h1 + 1 + w[0:GRP] + w[3 * GRP:4 * GRP] + fl
                ebh[:, t2] = h_out[:, L - 1]
                h1, h2 = h_out, h1
            store(c, ebh, enegv, enegv, enegv)
        return out
    for c in range(chunks):
        ebh = enegv.clone()
        for t2 in range(CHUNK):
            h_out = h1 + 1 if lev == 37 else h1 + 1 + wS
            if lev >= 33:
                ebh[:, t2] = h_out[:, L - 1]
            h1, h2 = h_out, h1
        if lev != 36:
            store(c, ebh if lev >= 33 else enegv, enegv, enegv, enegv)
    if lev == 35:
        out[3][:, CHUNK:2 * CHUNK] = h1[:, :CHUNK]
    else:
        out[0][:, :CHUNK] = h1[:, :CHUNK]
    return out


def _plain50(a: dict, chunks: int) -> list:
    """mosaic_repro.py:29-99: a (block, chunk) grid whose carry passes
    from chunk to chunk in scratch: here one loop over the chunks."""
    dev = a["dl"].device
    B = a["dl"].shape[0]
    nblk = B // GRP
    base0 = int(a["sca"][2])
    lanes = torch.arange(L, device=dev, dtype=I32)[None]
    tiles = _tiles(a["stk"], nblk)
    out = _outputs(B, chunks, dev)
    h1 = torch.full((B, L), NEV, dtype=I32, device=dev)
    h2 = h1.clone()
    for c in range(chunks):
        fl0 = a["fills"][c, 0]                              # (B, CHUNK)
        ebh = torch.full((B, CHUNK), NEV, dtype=I32, device=dev)
        ebf = ebh.clone()
        for t2 in range(CHUNK):
            t = c * CHUNK + t2
            bq = min(max(base0 - t + 128, 0), NBT * 128 - 256)
            q, rr = bq // 128, bq % 128
            pair = torch.cat([tiles[:, q], tiles[:, q + 1]], dim=-1)
            fv = fl0[:, t2:t2 + 1]
            h_out = (h1 + 1 + _sub(pair, 0)[:, rr:rr + L]
                     + _sub(pair, 3)[:, rr:rr + L]
                     + torch.where(lanes == 0, fv, h2) + a["dl"])
            ebh[:, t2] = h_out[:, L - 1]
            ebf[:, t2] = fv[:, 0]
            h1, h2 = h_out, h1
        for o, v in zip(out, (ebh, ebf, ebh, ebf)):
            o[:, c * CHUNK:(c + 1) * CHUNK] = v
    return out


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    so, _, _ = build_library(SOURCE)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mosaic_repro.argtypes = [I] + [P] * 10 + [I] * 3 + [P] * 4
    lib.mosaic_repro.restype = I
    lib.mosaic_repro_error_string.argtypes = [I]
    lib.mosaic_repro_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.mosaic_repro_error_string
    return lib


def reset_counts() -> None:
    launches.clear()


def run(level: int, a: dict, chunks: int = N_CHUNKS) -> list:
    """``level`` on the tensors ``a`` (level_inputs): one launch of its
    skeleton_kernel instance (one CTA of 1,024 threads a GRP block) for
    CUDA tensors, counted in ``launches`` as "level<n>"; the plain
    version for CPU ones."""
    dev = a["dl"].device
    if dev.type == "cpu":
        return plain(level, a, chunks)
    lev = instance(level)
    B = a["dl"].shape[0]
    check_level(level, B, chunks)
    nblk = B // GRP
    _check("sca", a["sca"], I32, (8,), dev)
    _check("dl", a["dl"], I32, (B, L), dev)
    if lev == 50:
        _check("stk", a["stk"], I32, (nblk * NBT, SOP * GRP, 128), dev)
        _check("fills", a["fills"], I32, (chunks, 3, B, CHUNK), dev)
        rest = [a["dl"]] * 5                  # unread by level 50
        qp = a["dl"]
    else:
        for k in ("nb", "mb", "ec", "colm", "colm1"):
            _check(k, a[k], I32, (B, L), dev)
        _check("qp", a["qp"], I32, (NCLASS, B, L), dev)
        rows = a["stk"].shape[1]
        if rows not in (SOP * GRP, 8 * GRP):
            raise ValueError(f"stk: tiles of {rows} rows, expected "
                             f"{SOP * GRP} or {8 * GRP}")
        _check("stk", a["stk"], I32, (nblk * NBT, rows, 128), dev)
        _check("fills", a["fills"], I32, (nblk * chunks, 3 * GRP, CHUNK),
               dev)
        rest = [a[k] for k in ("nb", "mb", "ec", "colm", "colm1")]
        qp = a["qp"]
    out = _outputs(B, chunks, dev)
    _launch(ENTRY, dev, lev, _ptr(a["sca"]), _ptr(a["dl"]),
            *(_ptr(x) for x in rest), _ptr(qp), _ptr(a["stk"]),
            _ptr(a["fills"]), B, chunks, a["stk"].shape[1],
            *(_ptr(o) for o in out), loader=_library)
    key = f"level{level}"
    launches[key] = launches.get(key, 0) + 1
    return out


def bound_work(level: int, a: dict, chunks: int) -> tuple[int, int]:
    """(bytes, int32 operations) a level's call needs: each input read
    once, each output written once; OPS over the lanes that reach an
    output, every step."""
    B = a["dl"].shape[0]
    nbytes = sum(4 * t.numel() for t in a.values()) + 4 * 4 * B * CHUNK \
        * chunks
    lanes, ops = OPS[instance(level)]
    return nbytes, B * lanes * ops * CHUNK * chunks


def step_ns(level: int, a_of, chunks: int, device, reps: int = 3
            ) -> tuple[float, float, float]:
    """(ns a step, ms at ``chunks``, ms at 2 ``chunks``) of a level's
    call; ``a_of(chunks)`` gives its inputs at that many chunks."""
    a1, a2 = a_of(chunks), a_of(2 * chunks)
    run(level, a1, chunks)
    t1 = elapsed_ms(lambda: run(level, a1, chunks), device, reps)
    t2 = elapsed_ms(lambda: run(level, a2, 2 * chunks), device, reps)
    return (t2 - t1) / (CHUNK * chunks) * 1e6, t1, t2


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spaln_tpu_torch.probes.mosaic_repro",
        description=__doc__.splitlines()[0])
    p.add_argument("levels", nargs="*", type=int,
                   help="one level: that level; none: levels 0-4 (the "
                        "script's)")
    p.add_argument("--B", type=int, default=None,
                   help="problems (default: each level's script_B)")
    p.add_argument("--sop8", action="store_true")
    p.add_argument("--chunks", type=int, default=N_CHUNKS)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use "
                         "--device cpu to run the plain versions)")
    dev = torch.device(args.device)
    levels = args.levels or list(range(5))

    def a_of(level, chunks):
        return level_inputs(level, inputs(args.B or script_B(level), chunks,
                                          args.sop8), dev)

    failed = 0
    for lev in levels:
        try:
            a = a_of(lev, args.chunks)
            got = run(lev, a, args.chunks)
            if dev.type == "cuda":
                want = plain(lev, a, args.chunks)
                bad = [i for i, (x, y) in enumerate(zip(got, want))
                       if not torch.equal(x, y)]
                if bad:
                    raise AssertionError(f"outputs {bad} differ from the "
                                         f"plain version")
            ns, t1, _ = step_ns(lev, lambda ch, lev=lev: a_of(lev, ch),
                                args.chunks, dev)
            print(f"PASS level {lev}  {t1:9.3f} ms  {ns:9.2f} ns/step",
                  flush=True)
        except (ValueError, AssertionError, RuntimeError) as e:
            failed += 1
            print(f"FAIL level {lev} | {str(e)[:200]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
