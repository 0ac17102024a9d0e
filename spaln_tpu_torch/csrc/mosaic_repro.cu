// Growing skeletons of the slab kernel's step on an NVIDIA Hopper GPU: the
// counterpart of scripts/mosaic_repro.py's build(level), whose three
// pallas_calls (93: level 50; 265: levels 32 and up; 449: the others) add
// the pieces of spaln_tpu's slab step one at a time to a bare loop over
// an (8, 128) int32 carry.  skeleton_kernel<LEVEL> is instanced for every
// level the script distinguishes and computes exactly what the script
// computes (levels 1-4 and 6-8 with the stack tile read as (SOP, GRP, 128)
// and the fills block as (3, GRP, CHUNK), the layout they were written
// for); the plain PyTorch versions and the wrapper are in
// spaln_tpu_torch/probes/mosaic_repro.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmosaic_repro.so mosaic_repro.cu
//
// Design.  One CTA of 1,024 threads holds a block of GRP = 8 rows: thread
// (g, j) owns lane j of row g, its carry h1 (and h2) in registers, four
// warps a row.  The pieces of the step on the card's own terms:
//   the operand read   the TPU concatenates tiles q and q+1 and rotates
//                      the 256-wide pair by -r; here the thread reads
//                      column j + r of the pair with __ldg (tile q + (j +
//                      r) / 128), the same value, nothing moved;
//   the one-hot score, a static tile, dl   step-invariant, read once;
//   the fills value    lane 0 reads column t2 of its row of the chunk's
//                      fills tile (the TPU's masked lane sum);
//   shift_right        __shfl_up_sync within a warp; lane 0 of warps 1-3
//                      of a row takes lane 31's h1 of the warp before
//                      through shared memory, double-buffered by step
//                      parity: one __syncthreads() a step, where the
//                      level shifts (2-4);
//   the row and rc reductions   the lanes with j == li add their value
//                      into the step's slot in shared memory (atomics:
//                      li may hold at several lanes, or none); the lane
//                      j == rcl writes it (lane 0 writes 0 where rcl is
//                      off the row);
//   the emissions      lane 127 writes its value into slot t2 of the
//                      chunk's shared block (double-buffered by chunk
//                      parity); at the chunk's end (every step at level
//                      45) a barrier, and each thread stores column j of
//                      the block, coalesced: the TPU's per-chunk stores.
// Level 50's grid over chunks with a scratch carry is one loop over the
// chunks with the carry in registers.  The step loop runs one step an
// iteration (#pragma unroll 1) and the carry passes through opaque() (an
// empty asm nvcc must assume changes it), so no step folds into the next;
// nvcc may hoist what does not change from step to step and drop what
// no output reads (level 30's emissions, level 36's accumulator), which
// the bound does not count either.  Integer sums wrap, as XLA's.
//
// Bound on the H100: the dependent chain of a step on one SM (a few
// operations and, where a level shifts or emits, a barrier), far below
// the bytes or operations of the whole call; the probe measures the ns a
// step each piece adds (T-differenced by the wrapper's callers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GRP = 8, L = 128, CHUNK = 128, NBT = 12, NCLASS = 5;
constexpr int NEV = -939524096;          // -(2**31 // 16 * 7)
constexpr int THREADS = GRP * L;         // thread (g, j): lane j of row g
constexpr int QMAX = NBT * 128 - 256;    // the clip of the pair's column
constexpr int BASE_WHOLE = 900 + 128;    // levels >= 38: 900 + LTREPRO
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
// jnp's // on ints: the quotient rounded down
__device__ __forceinline__ int fdiv(int a, int m) {
  const int q = a / m;
  return (a % m != 0 && ((a < 0) != (m < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// What each level's step is made of.
struct Pieces {
  bool whole;       // the level >= 32 kernel (B = GRP, whole arrays)
  bool pair3;       // the operand read, sub-tiles 0, 3, 4 (1, 6)
  bool pair2;       // the operand read, sub-tiles 0, 3 (12, 40, 42-46, 50)
  bool roll1;       // one tile rotated (7)
  bool tileq;       // tile q, no rotation (8, 10)
  bool win3;        // a 384-wide window of three tiles a chunk (38)
  bool shift;       // fills, shift_right, edge selects (2-4)
  bool active;      // the active mask (3, 4)
  bool rowrc;       // the row and rc reductions (4)
  bool score;       // the one-hot score (5, 6)
  bool static3;     // the static tile 3 (9, 30-36)
  bool fills2;      // the static fills tile 2 (11)
  bool fillchunk;   // the fills tile of the step's chunk (38, 40, 43-46)
  bool lvl50;       // lane 0's fills value and h2, + dl (50)
  bool emit;        // lane 127 into the first output's block
  bool last_h1;     // the final h1 into lanes 0-127 of an output
};

__host__ __device__ constexpr Pieces pieces(int v) {
  Pieces p{};
  p.whole = v >= 32 && v < 50;
  p.pair3 = v == 1 || v == 6;
  p.pair2 = v == 12 || v == 40 || (v >= 42 && v <= 46) || v == 50;
  p.roll1 = v == 7;
  p.tileq = v == 8 || v == 10;
  p.win3 = v == 38;
  p.shift = v >= 2 && v <= 4;
  p.active = v == 3 || v == 4;
  p.rowrc = v == 4;
  p.score = v == 5 || v == 6;
  p.static3 = v == 9 || v == 30 || v == 31 || (v >= 32 && v <= 36);
  p.fills2 = v == 11;
  p.fillchunk = v == 38 || v == 40 || (v >= 43 && v <= 46);
  p.lvl50 = v == 50;
  p.emit = !(v == 30 || v == 32 || v == 36);
  p.last_h1 = v >= 30 && v <= 37;
  return p;
}

// B/GRP CTAs of THREADS threads.  Inputs as the script's (row-major):
// sca (8); dl, nb, mb, ec, colm, colm1 (B, 128); qp (5, B, 128); stk
// (B/GRP * 12, rows, 128); fills (B/GRP * nch, 3 GRP, 128), or (nch, 3,
// B, 128) at level 50; outputs (B, 128 nch), each element the level
// writes written.
template <int LEV>
__global__ void __launch_bounds__(THREADS, 1)
skeleton_kernel(const int* __restrict__ sca, const int* __restrict__ dl,
                const int* __restrict__ nb, const int* __restrict__ mb,
                const int* __restrict__ ec, const int* __restrict__ colm,
                const int* __restrict__ colm1, const int* __restrict__ qp,
                const int* __restrict__ stk, const int* __restrict__ fills,
                int B, int nch, int rows, int* __restrict__ bh,
                int* __restrict__ bf, int* __restrict__ row,
                int* __restrict__ rc) {
  constexpr Pieces P = pieces(LEV);
  __shared__ int em_h[2][GRP][CHUNK];    // lane 127's emissions
  __shared__ int em_x[2][GRP][CHUNK];    // rc (4), the fills value (50)
  __shared__ int em_row[2][GRP][CHUNK];  // the row sums (4)
  __shared__ int xh[2][GRP][4];          // lane 31's h1 by warp (2-4)
  const int tid = threadIdx.x;
  const int g = tid >> 7, j = tid & (L - 1);
  const int wq = j >> 5, lane = tid & 31;
  const int blk = blockIdx.x;
  const int b = blk * GRP + g;
  const int Tpad = nch * CHUNK;
  const size_t e = (size_t)b * L + j;
  const int m0 = sca[0], lw0 = sca[1], base0 = sca[2];
  const int tb = P.whole ? 0 : blk * NBT;     // the block's first tile
  // element (sub-tile s, row g) of the stack at tile q, column col of the
  // tiles that follow it
  auto stack = [&](int q, int col, int s) {
    return __ldg(stk + ((size_t)(tb + q + (col >> 7)) * rows + s * GRP + g)
                           * 128 + (col & 127));
  };
  int cst = 0;                                 // step-invariant terms
  if constexpr (P.score) {
    const int code = __ldg(stk + (size_t)(tb + 3) * rows * 128 + j);
    cst = code >= 0 && code < NCLASS
              ? __ldg(qp + ((size_t)code * B + b) * L + j) : 0;
  }
  if constexpr (P.static3) cst = wadd(stack(3, j, 0), stack(3, j, 3));
  if constexpr (P.fills2)
    cst = __ldg(fills + ((size_t)(blk * nch + 2) * 3 * GRP + g) * CHUNK + j);
  if constexpr (P.lvl50) cst = __ldg(dl + e);
  int dl_j = 0, nb_j = 0, ec_j = 0, colm_j = 0, colm1_j = 0;
  bool m_ok = false, rowlane = false;
  int d0 = 0, n0b = 0;
  if constexpr (P.shift) {
    dl_j = __ldg(dl + e); nb_j = __ldg(nb + e); ec_j = __ldg(ec + e);
    colm_j = __ldg(colm + e); colm1_j = __ldg(colm1 + e);
    const int mb_j = __ldg(mb + e);
    m_ok = m0 + j >= 1 && m0 + j <= mb_j;
    rowlane = j == clampi(mb_j - m0, 0, L - 1);
    d0 = __ldg(dl + (size_t)b * L);
    n0b = __ldg(nb + (size_t)b * L);
  }
  if constexpr (P.rowrc) {
    em_row[0][g][j] = 0;
    em_row[1][g][j] = 0;
    __syncthreads();
  }
  const int base = P.whole ? BASE_WHOLE : base0 + 128;
  int h1 = NEV, h2 = NEV;
  int upraw = NEV;            // h1 of lane j-1 a step before: h2's shift
  for (int c = 0; c < nch; ++c) {
    const int par = c & 1;
    int fl = 0, q0 = 0;
    if constexpr (P.fillchunk)
      fl = __ldg(fills + ((size_t)min(c, nch - 1) * 3 * GRP + g) * CHUNK + j);
    if constexpr (P.win3)
      q0 = clampi(fdiv(BASE_WHOLE - (c + 1) * CHUNK + 1, 128), 0, NBT - 3);
    const int* fch = fills + (size_t)(blk * nch + c) * 3 * GRP * CHUNK;
    const int* f50 = fills + ((size_t)c * 3 * B + b) * CHUNK;
#pragma unroll 1
    for (int t2 = 0; t2 < CHUNK; ++t2) {
      const int t = c * CHUNK + t2;
      int h = wadd(wadd(h1, 1), cst);
      if constexpr (P.pair3 || P.pair2 || P.roll1 || P.tileq) {
        const int bq = clampi(base - t, 0, QMAX);
        const int q = bq >> 7, r = bq & 127;
        if constexpr (P.pair3)
          h = wadd(wadd(wadd(h, stack(q, j + r, 0)), stack(q, j + r, 3)),
                   stack(q, j + r, 4));
        if constexpr (P.pair2)
          h = wadd(wadd(h, stack(q, j + r, 0)), stack(q, j + r, 3));
        if constexpr (P.roll1)
          h = wadd(wadd(h, stack(q, (j + r) & 127, 0)),
                   stack(q, (j + r) & 127, 3));
        if constexpr (P.tileq)
          h = wadd(wadd(h, stack(q, j, 0)), stack(q, j, 3));
      }
      if constexpr (P.win3) {
        const int rr = clampi(BASE_WHOLE - t - q0 * 128, 0, 255);
        h = wadd(wadd(h, stack(q0, j + rr, 0)), stack(q0, j + rr, 3));
      }
      if constexpr (P.fillchunk) h = wadd(h, fl);
      int fv = 0;
      if constexpr (P.lvl50) {
        if (j == 0) fv = __ldg(f50 + t2);
        h = wadd(h, j == 0 ? fv : h2);
      }
      if constexpr (P.shift) {
        int up = __shfl_up_sync(FULL, h1, 1);
        if (lane == 31) xh[t & 1][g][wq] = h1;
        __syncthreads();
        if (lane == 0 && wq > 0) up = xh[t & 1][g][wq - 1];
        int diag = upraw;
        upraw = up;
        if (j == 0) {
          diag = __ldg(fch + (size_t)g * CHUNK + t2);
          up = __ldg(fch + (size_t)(GRP + g) * CHUNK + t2);
        }
        const int sc = m0 + lw0 + 1 + t;
        const int n = sc + dl_j - j;
        const int r_off = t - 2 * j;
        const bool first = r_off == 0;
        const bool edge = first && n != 1;
        const int left = n == 1 ? colm_j : edge ? ec_j : first ? NEV : h1;
        if (n == 1) diag = colm1_j;
        if (r_off >= 512 - 1) up = NEV;
        h = wadd(wadd(wadd(h, up), diag), left);
        if constexpr (P.active) {
          const bool active = r_off >= 0 && r_off < 512 && n >= 1
                              && n <= nb_j && m_ok;
          if (!active) h = NEV;
        }
        if constexpr (P.rowrc) {
          if (rowlane) atomicAdd(&em_row[par][g][t2], h);
          const int rcl = sc + d0 - n0b;
          if (j == rcl) em_x[par][g][t2] = h;
          else if (j == 0 && (rcl < 0 || rcl >= L)) em_x[par][g][t2] = 0;
        }
      }
      if constexpr (P.emit)
        if (j == L - 1) em_h[par][g][t2] = h;
      if constexpr (P.lvl50)
        if (j == 0) em_x[par][g][t2] = fv;
      h2 = h1;
      h1 = opaque(h);
      if constexpr (LEV == 45) {           // every step: the chunk's block
        __syncthreads();
        const size_t o = (size_t)b * Tpad + c * CHUNK + j;
        bh[o] = em_h[par][g][j];
        bf[o] = em_h[par][g][j];
        row[o] = NEV;
        rc[o] = NEV;
      }
    }
    if constexpr (LEV != 36 && LEV != 45) {   // the chunk's stores
      __syncthreads();
      const size_t o = (size_t)b * Tpad + c * CHUNK + j;
      const int vh = P.emit ? em_h[par][g][j] : NEV;
      if constexpr (LEV == 46) {
        bh[o] = vh;
      } else if constexpr (P.lvl50) {
        bh[o] = vh;
        bf[o] = em_x[par][g][j];
        row[o] = vh;
        rc[o] = em_x[par][g][j];
      } else if constexpr (P.whole && LEV < 40) {
        bh[o] = vh;
        bf[o] = NEV;
        row[o] = NEV;
        rc[o] = NEV;
      } else {
        bh[o] = vh;
        bf[o] = vh;
        if constexpr (P.rowrc) {
          row[o] = em_row[par][g][j];
          em_row[par][g][j] = 0;
          rc[o] = em_x[par][g][j];
        } else {
          row[o] = NEV;
          rc[o] = NEV;
        }
      }
    }
  }
  if constexpr (LEV == 35) rc[(size_t)b * Tpad + CHUNK + j] = h1;
  else if constexpr (P.last_h1) bh[(size_t)b * Tpad + j] = h1;
}

template <int LEV>
int launch(const int* sca, const int* dl, const int* nb, const int* mb,
           const int* ec, const int* colm, const int* colm1, const int* qp,
           const int* stk, const int* fills, int B, int nch, int rows,
           int* bh, int* bf, int* row, int* rc, cudaStream_t stream) {
  skeleton_kernel<LEV><<<B / GRP, THREADS, 0, stream>>>(
      sca, dl, nb, mb, ec, colm, colm1, qp, stk, fills, B, nch, rows, bh, bf,
      row, rc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mosaic_repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch of the skeleton of ``level`` (an instance the script
// distinguishes: 0-12, 30-38, 40-46, 50; the wrapper maps the others)
// over B rows (a multiple of GRP; GRP alone at 32-46) and nch chunks of
// 128 steps; rows: the stack tiles' rows (7 or 8 GRP).
int mosaic_repro(int level, const int* sca, const int* dl, const int* nb,
                 const int* mb, const int* ec, const int* colm,
                 const int* colm1, const int* qp, const int* stk,
                 const int* fills, int B, int nch, int rows, int* bh,
                 int* bf, int* row, int* rc, cudaStream_t stream) {
  if (B < GRP || B % GRP || nch < 1 || rows < 7 * GRP
      || (level >= 32 && level < 50 && B != GRP))
    return (int)cudaErrorInvalidValue;
#define MOSAIC_LEVEL(v)                                                  \
  case v:                                                                \
    return launch<v>(sca, dl, nb, mb, ec, colm, colm1, qp, stk, fills, B, \
                     nch, rows, bh, bf, row, rc, stream);
  switch (level) {
    MOSAIC_LEVEL(0) MOSAIC_LEVEL(1) MOSAIC_LEVEL(2) MOSAIC_LEVEL(3)
    MOSAIC_LEVEL(4) MOSAIC_LEVEL(5) MOSAIC_LEVEL(6) MOSAIC_LEVEL(7)
    MOSAIC_LEVEL(8) MOSAIC_LEVEL(9) MOSAIC_LEVEL(10) MOSAIC_LEVEL(11)
    MOSAIC_LEVEL(12) MOSAIC_LEVEL(30) MOSAIC_LEVEL(31) MOSAIC_LEVEL(32)
    MOSAIC_LEVEL(33) MOSAIC_LEVEL(34) MOSAIC_LEVEL(35) MOSAIC_LEVEL(36)
    MOSAIC_LEVEL(37) MOSAIC_LEVEL(38) MOSAIC_LEVEL(40) MOSAIC_LEVEL(41)
    MOSAIC_LEVEL(42) MOSAIC_LEVEL(43) MOSAIC_LEVEL(44) MOSAIC_LEVEL(45)
    MOSAIC_LEVEL(46) MOSAIC_LEVEL(50)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MOSAIC_LEVEL
}

}  // extern "C"
