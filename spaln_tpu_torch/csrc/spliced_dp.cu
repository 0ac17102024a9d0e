// Banded spliced DP of one geometry bucket on an NVIDIA Hopper GPU:
// three kernels behind a plain C interface (bound with ctypes by
// spaln_tpu_torch/ops/dp_spliced_cuda.py, which also holds their plain
// PyTorch versions).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libspliced_dp.so spliced_dp.cu
//
// Every entry launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of its launch.  All arithmetic is int32 x10
// fixed point and follows the operation order of spaln_tpu's scan step
// (spaln_tpu/ops/dp_spliced_scan.py:223-577), which fixes every
// tie-break, so results equal the reference's exactly.
//
// Layouts (row-major):
//   qprof (B, Mpad, A)        substitution row of query residue m-1
//   gops  (B, 6, Np)          per genome boundary n: residue g[n-1],
//                             donor mask, acceptor mask, sig5, acceptor
//                             base, donor dinucleotide code
//   joint (B, Np, 16)         acceptor term by donor dinucleotide
//   ipen  (Np,)               exact intron penalty by length
//   flags (S, T, B, L) u8     winner state | E open << 3 | F open << 4,
//                             255 = inactive cell
//   spj   (S, 3, T, B, L)     1 + donor boundary of an intron closed into
//                             state k at the cell, 0 = none
//   row   (B, Np)             H(M, n);  rc (B, Mpad + 1) H(m, N)
//   bnd_h, bnd_f (B, Np + 1)  scratch: H/F of the previous slab's last row
//   ends  (B, 3)              (score, end m, end n)
//   recs  (IT, B, 4)          walk records (kind, m, n, jnc - 1), zeroed
//                             by the caller
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEV = -939524096;          // NEVSEL (cmn.h:79, int build)
constexpr int NCAND = 4;                 // donor candidates per lane
constexpr int NSPJ = 3;                  // states H, E, F
constexpr int N_GOPS = 6;
enum { G_RES, G_ISDON, G_ISACC, G_SIG5, G_ACCB, G_DINC5 };
__device__ __constant__ int PSP_BIT[3] = {4, 1, 8};   // aln.h:56-59

__device__ __forceinline__ int colinit(int k, int b_exgl, int gop,
                                       int gep) {
  // H[m][0]: free query prefix, or an affine gap of length k
  return (b_exgl || k == 0) ? 0 : gop + gep * k;
}

// ---------------------------------------------------------------- K1
// spliced_slab_trace replaces spaln_tpu's Pallas kernel
// _make_kernel(emit_trace=True) (ops/dp_spliced_pallas.py:195-694, via
// _slab_call 698-835) and the per-slab loop of _fused_call (1103-1121).
//
// Design: one CTA of L threads per problem; thread i owns query row
// m = m0 + i of the current slab and at wavefront step t computes cell
// n = m0 + lw + 1 + t - i.  The CTA walks all slabs in order inside one
// launch.  Up and diagonal values come from thread i-1 through a ring in
// shared memory (H of steps t-1 and t-2, F of step t-1) with one
// __syncthreads() per step; thread 0 reads the previous slab's last row,
// which thread L-1 of this CTA wrote to global scratch (it overwrites a
// column only after thread 0 has read it: L >= 3).  The intron penalty
// is gathered straight from the dense table in global memory.
//
// Bound on the H100: the serial dependence through the wavefront.  One
// CTA per problem gives B CTAs (<= 32 on the main path) on 132 SMs, and
// every step pays a barrier plus the latency of a few dependent global
// loads (genome operands, penalty, joint term); the plane writes,
// 13 B per cell, are the only large traffic.  The simple design keeps
// the per-cell state (H, E, psp, 4 sorted donor candidates) in
// registers and reads operands in per-step coalesced runs; it does not
// try to hide the latency yet.
__global__ void __launch_bounds__(256)
slab_trace_kernel(const int* __restrict__ qprof,
                  const int* __restrict__ gops,
                  const int* __restrict__ joint,
                  const int* __restrict__ ipen,
                  const int* __restrict__ Ms, const int* __restrict__ Ns,
                  const int* __restrict__ lws, int B, int A, int S, int W,
                  int T, int Mpad, int Np, int gop, int gep, int llmt,
                  int a_exgl, int a_exgr, int b_exgl, int* bnd_h,
                  int* bnd_f, unsigned char* __restrict__ flags,
                  int* __restrict__ spj, int* __restrict__ row,
                  int* __restrict__ rc) {
  extern __shared__ int smem[];
  const int L = blockDim.x;
  const int i = threadIdx.x;
  const int b = blockIdx.x;
  int* Hs = smem;              // 3 x L: H by step mod 3
  int* Fs = smem + 3 * L;      // 2 x L: F by step mod 2
  int* qp = smem + 5 * L;      // L x A: this slab's substitution rows
  const int M = Ms[b], N = Ns[b], lw = lws[b];
  const int nb = Np + 1;
  int* bh = bnd_h + (size_t)b * nb;
  int* bf = bnd_f + (size_t)b * nb;
  int* rowb = row + (size_t)b * Np;
  int* rcb = rc + (size_t)b * (Mpad + 1);
  const int* gb = gops + (size_t)b * N_GOPS * Np;
  const int* jb = joint + (size_t)b * Np * 16;
  for (int n = i; n < nb; n += L) {          // row 0
    bh[n] = n <= N ? (a_exgl ? 0 : colinit(n, 0, gop, gep)) : NEV;
    bf[n] = NEV;
  }
  for (int n = i; n < Np; n += L) rowb[n] = NEV;
  for (int m = i; m <= Mpad; m += L) rcb[m] = NEV;
  const int e_const =
      lw >= -M ? colinit(lw < 0 ? -lw : 0, b_exgl, gop, gep) : NEV;
  const size_t plane = (size_t)T * B * L;    // one (T, B, L) plane
  const size_t tstride = (size_t)B * L;

  for (int s = 0; s < S; ++s) {
    const int m0 = s * L + 1;
    const int m = m0 + i;
    const int* qsrc = qprof + ((size_t)b * Mpad + (m0 - 1)) * A;
    for (int k = i; k < L * A; k += L) qp[k] = qsrc[k];
    Hs[i] = NEV; Hs[L + i] = NEV; Hs[2 * L + i] = NEV;
    Fs[i] = NEV; Fs[L + i] = NEV;
    int h1 = NEV, e1 = NEV, psp = 0;
    int cv[NCAND], cj[NCAND], cd[NCAND], c5[NCAND];
#pragma unroll
    for (int l = 0; l < NCAND; ++l) { cv[l] = NEV; cj[l] = cd[l] = c5[l] = 0; }
    const int col_m = colinit(m, b_exgl, gop, gep);
    const int col_m1 = colinit(m - 1, b_exgl, gop, gep);
    const bool internal = !a_exgr || m < M;
    unsigned char* fl_out = flags + (size_t)s * plane + (size_t)b * L + i;
    int* spj_out = spj + (size_t)s * NSPJ * plane + (size_t)b * L + i;
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      const int n = m0 + lw + 1 + t - i;
      const int r_off = t - 2 * i;
      const bool first = r_off == 0;
      const bool active =
          r_off >= 0 && r_off < W && n >= 1 && n <= N && m <= M;
      int score = 0, isdon = 0, isacc = 0, sig5 = 0, accb = 0, dinc5 = 0;
      if (active) {
        score = qp[i * A + gb[G_RES * Np + n]];
        if (n < N) {
          isdon = gb[G_ISDON * Np + n];
          isacc = gb[G_ISACC * Np + n];
          sig5 = gb[G_SIG5 * Np + n];
          accb = gb[G_ACCB * Np + n];
          dinc5 = gb[G_DINC5 * Np + n];
        }
      }
      // ---- neighbour values
      int up_h, up_f, diag_h;
      if (i == 0) {
        const bool ok_up = n >= 0 && n <= N + 1;
        up_h = ok_up ? bh[n] : NEV;
        up_f = ok_up ? bf[n] : NEV;
        diag_h = (n >= 1 && n - 1 <= N) ? bh[n - 1] : NEV;
      } else {
        up_h = Hs[((t + 2) % 3) * L + i - 1];       // lane i-1, step t-1
        up_f = Fs[((t + 1) & 1) * L + i - 1];
        diag_h = Hs[((t + 1) % 3) * L + i - 1];     // lane i-1, step t-2
      }
      // column 0 and the band's left edge (dp_spliced_ref init)
      const bool edge = first && n != 1;
      const int left_h =
          n == 1 ? col_m : (edge ? e_const : (first ? NEV : h1));
      if (n == 1) diag_h = col_m1;
      if (r_off >= W - 1) { up_h = NEV; up_f = NEV; }
      if (first) {
        e1 = NEV;
        psp = 0;
#pragma unroll
        for (int l = 0; l < NCAND; ++l) {
          cv[l] = NEV; cj[l] = cd[l] = c5[l] = 0;
        }
      }
      // ---- recurrence (order = fwd2s1.cc:276-431)
      const int h_val = diag_h + score;
      int mx = h_val, mk = 0;
      int xo = up_h + gop;
      const bool f_open = xo >= up_f;
      const int f_val = (f_open ? xo : up_f) + gep;
      if (f_val > mx) { mx = f_val; mk = 2; }
      const int prev_psp = psp;
      xo = left_h + gop;
      const bool e_open = xo >= e1;
      const int e_val = (e_open ? xo : e1) + gep;
      psp = e_open ? (prev_psp != 0 ? 1 : 0) : (prev_psp & 1);
      if (e_val >= mx) { mx = e_val; mk = 1; }
      int sv[NSPJ] = {h_val, e_val, f_val};
      int jn[NSPJ] = {0, 0, 0};
      // ---- acceptor close (fwd2s1.cc:333-354)
      if (isacc && internal) {
        int xc[NCAND];
        bool ok[NCAND];
#pragma unroll
        for (int l = 0; l < NCAND; ++l) {
          const int ilen = n - cj[l];
          ok[l] = ilen >= llmt && cv[l] > NEV / 2;
          xc[l] = NEV;
          if (ok[l]) {
            const int pen = ilen < 0 ? NEV / 2 : ipen[min(ilen, Np - 1)];
            xc[l] = cv[l] + pen + accb + jb[(size_t)n * 16 + c5[l]];
          }
        }
#pragma unroll
        for (int k = 0; k < NSPJ; ++k) {
          int cur = sv[k], jnc = 0;
#pragma unroll
          for (int l = 0; l < NCAND; ++l)             // best-first order
            if (cd[l] == k && ok[l] && xc[l] >= cur) {
              cur = xc[l];
              jnc = cj[l] + 1;
            }
          sv[k] = cur;
          jn[k] = jnc;
          if (jnc > 0) {
            psp |= PSP_BIT[k];
            if (cur >= mx) { mx = cur; mk = k; }
          }
        }
      }
      // ---- donor push (fwd2s1.cc:380-406): sorted insertion, ties keep
      // existing entries first
      if (isdon && internal) {
#pragma unroll
        for (int k = 0; k < NSPJ; ++k) {
          const int fv = sv[k];
          bool elig = (k != 0 || mk == 0) && (psp & PSP_BIT[k]) == 0;
          const int gk = (mk == 0 || ((k - mk) & 1)) ? (k / 2 ? gop : 0)
                                                     : 0;
          if (k != mk && fv <= mx + gk) elig = false;
          if (elig) {
            const int x = fv + sig5;
            int pos = 0;
#pragma unroll
            for (int l = 0; l < NCAND; ++l) pos += cv[l] >= x;
#pragma unroll
            for (int l = NCAND - 1; l >= 1; --l)
              if (l > pos) {
                cv[l] = cv[l - 1]; cj[l] = cj[l - 1];
                cd[l] = cd[l - 1]; c5[l] = c5[l - 1];
              }
#pragma unroll
            for (int l = 0; l < NCAND; ++l)
              if (l == pos) { cv[l] = x; cj[l] = n; cd[l] = k; c5[l] = dinc5; }
          }
        }
      }
      // ---- masked commit and emissions
      const int h_out = active ? mx : NEV;
      const int f_out = active ? sv[2] : NEV;
      if (active) e1 = sv[1];
      h1 = h_out;
      Hs[(t % 3) * L + i] = h_out;
      Fs[(t & 1) * L + i] = f_out;
      fl_out[(size_t)t * tstride] =
          active ? (unsigned char)(mk | (e_open << 3) | (f_open << 4))
                 : (unsigned char)255;
#pragma unroll
      for (int k = 0; k < NSPJ; ++k)
        spj_out[(size_t)k * plane + (size_t)t * tstride] = jn[k];
      if (active) {
        if (m == M) rowb[n] = h_out;
        if (n == N) rcb[m] = h_out;
        if (i == L - 1) { bh[n] = h_out; bf[n] = f_out; }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- K2e
// spliced_last_ends replaces the lastS end extraction of _fused_call
// (ops/dp_spliced_pallas.py:1122-1178), with the semantics of the host
// collect_batch_results (ops/dp_spliced_scan.py:938-1006): strict >
// between candidate groups, first maximum within a segment, empty
// segments skipped.
//
// Design: one CTA per problem; the threads stride over the final-row and
// right-column segments and reduce (max, first index) through shared
// memory.  Bound on the H100: launch latency; it reads (N + M) ints per
// problem, a few hundred KB per bucket.
constexpr int ENDS_THREADS = 256;

__device__ void seg_best(const int* v, int lo, int hi, int* sv, int* si,
                         int* out_v, int* out_i) {
  int bv = 0, bi = -1;
  for (int k = lo + (int)threadIdx.x; k < hi; k += blockDim.x)
    if (bi < 0 || v[k] > bv) { bv = v[k]; bi = k; }
  sv[threadIdx.x] = bv;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) {
      const int ov = sv[threadIdx.x + w], oi = si[threadIdx.x + w];
      const int cv = sv[threadIdx.x], ci = si[threadIdx.x];
      if (oi >= 0 && (ci < 0 || ov > cv || (ov == cv && oi < ci))) {
        sv[threadIdx.x] = ov;
        si[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  *out_v = sv[0];
  *out_i = si[0];
  __syncthreads();
}

__global__ void last_ends_kernel(const int* __restrict__ row,
                                 const int* __restrict__ rc,
                                 const int* __restrict__ Ms,
                                 const int* __restrict__ Ns,
                                 const int* __restrict__ lws, int Np,
                                 int Mpad, int W, int gop, int gep,
                                 int a_exgl, int a_exgr, int b_exgl,
                                 int b_exgr, int* __restrict__ ends) {
  __shared__ int sv[ENDS_THREADS];
  __shared__ int si[ENDS_THREADS];
  const int b = blockIdx.x;
  const int M = Ms[b], N = Ns[b], lw = lws[b];
  const int up = lw + W - 1;
  const int* rowb = row + (size_t)b * Np;
  const int* rcb = rc + (size_t)b * (Mpad + 1);
  int bv = rowb[N], bm = M, bn = N;
  int v, k;
  if (a_exgr) {
    const int n_first = max(M + lw, 0);
    // stale band-edge / column-0 corner candidates come first
    if (lw >= -M) {
      v = colinit(-lw, b_exgl, gop, gep);
      if (v > bv) { bv = v; bm = M; bn = n_first; }
    } else if (n_first == 0) {
      v = colinit(M, b_exgl, gop, gep);
      if (v > bv) { bv = v; bm = M; bn = 0; }
    }
    seg_best(rowb, max(n_first, 1), N, sv, si, &v, &k);
    if (k >= 0 && v > bv) { bv = v; bm = M; bn = k; }
  }
  if (b_exgr) {
    if (max(N - up, 0) == 0) {
      v = a_exgl ? 0 : gop + gep * N;
      if (v > bv) { bv = v; bm = 0; bn = N; }
    }
    seg_best(rcb, max(N - up, 1), M, sv, si, &v, &k);
    if (k >= 0 && v > bv) { bv = v; bm = k; bn = N; }
  }
  if (threadIdx.x == 0) {
    ends[b * 3] = bv;
    ends[b * 3 + 1] = bm;
    ends[b * 3 + 2] = bn;
  }
}

// ---------------------------------------------------------------- K3
// spliced_tb_walk replaces the device traceback walker _tb_walker
// (ops/dp_spliced_scan.py:1127-1196): from each problem's end cell it
// follows the winner state, gap-open bits and junction planes back to
// row or column 0, one (kind, m, n, jnc - 1) record per step.
//
// Design: one thread per problem, a loop of at most IT steps that stops
// when the walk ends (the caller zeroes the records).  Bound on the
// H100: the chain of dependent global loads, two or three per step, one
// step per path cell; B threads leave the card nearly idle, but a walk
// is ~M + W steps against the forward's S * T * L cells per problem.
__global__ void tb_walk_kernel(const unsigned char* __restrict__ flags,
                               const int* __restrict__ spj,
                               const int* __restrict__ ends,
                               const int* __restrict__ lws, int B, int L,
                               int S, int T, int IT,
                               int* __restrict__ recs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int lw = lws[b];
  int m = ends[b * 3 + 1], n = ends[b * 3 + 2], st = 0;
  bool done = m < 1 || n < 1;
  const size_t plane = (size_t)T * B * L;
  for (int it = 0; it < IT && !done; ++it) {
    const int s = (m - 1) / L, i = (m - 1) % L;     // m >= 1 here
    const int t = (n - m) - lw - 1 + 2 * i;
    const bool ok = t >= 0 && t < T && s < S;
    int fl = 255, jnc_s = 0, jnc_0 = 0;
    if (ok) {
      const size_t cell = ((size_t)t * B + b) * L + i;
      fl = flags[(size_t)s * plane + cell];
      const int stc = min(max(st, 0), NSPJ - 1);
      jnc_s = spj[((size_t)s * NSPJ + stc) * plane + cell];
      jnc_0 = spj[(size_t)s * NSPJ * plane + cell];
    }
    const int hd = fl & 7;
    const bool is0 = st == 0;
    const bool dead = is0 && (fl == 255 || (fl & 0x80) || hd > 4);
    const bool i_close0 = is0 && !dead && hd == 0 && jnc_0 > 0;
    const bool diag = is0 && !dead && hd == 0 && jnc_0 == 0;
    const bool trans = is0 && !dead && hd > 0 && hd <= 4;
    const bool gsel = !is0;
    const bool i_close_g = gsel && jnc_s > 0;
    const bool horiz = gsel && jnc_s == 0 && (st == 1 || st == 3);
    const bool vert = gsel && jnc_s == 0 && (st == 2 || st == 4);
    const int obit = st == 1 ? 8 : st == 2 ? 16 : st == 3 ? 32
                   : st == 4 ? 64 : 0;
    const bool opened = (fl & obit) != 0;
    const bool i_close = i_close0 || i_close_g;
    const int jncv = is0 ? jnc_0 : jnc_s;
    const int kind = (!ok || dead || trans) ? 0
                     : i_close ? 4 : diag ? 1 : horiz ? 2 : 3;
    int* r = recs + ((size_t)it * B + b) * 4;
    r[0] = kind; r[1] = m; r[2] = n; r[3] = jncv - 1;
    const int n2 = i_close ? jncv - 1 : ((diag || horiz) ? n - 1 : n);
    const int m2 = (diag || vert) ? m - 1 : m;
    st = trans ? hd : (((horiz || vert) && opened) ? 0 : st);
    done = dead || !ok || m2 < 1 || n2 < 1;
    m = m2;
    n = n2;
  }
}

}  // namespace

extern "C" {

const char* spliced_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int spliced_slab_trace(const int* qprof, const int* gops, const int* joint,
                       const int* ipen, const int* Ms, const int* Ns,
                       const int* lws, int B, int L, int A, int S, int W,
                       int T, int Mpad, int Np, int gop, int gep, int llmt,
                       int a_exgl, int a_exgr, int b_exgl, int smem_bytes,
                       int* bnd_h, int* bnd_f, unsigned char* flags,
                       int* spj, int* row, int* rc, cudaStream_t stream) {
  slab_trace_kernel<<<B, L, smem_bytes, stream>>>(
      qprof, gops, joint, ipen, Ms, Ns, lws, B, A, S, W, T, Mpad, Np, gop,
      gep, llmt, a_exgl, a_exgr, b_exgl, bnd_h, bnd_f, flags, spj, row, rc);
  return (int)cudaGetLastError();
}

int spliced_last_ends(const int* row, const int* rc, const int* Ms,
                      const int* Ns, const int* lws, int B, int Np,
                      int Mpad, int W, int gop, int gep, int a_exgl,
                      int a_exgr, int b_exgl, int b_exgr, int* ends,
                      cudaStream_t stream) {
  last_ends_kernel<<<B, ENDS_THREADS, 0, stream>>>(
      row, rc, Ms, Ns, lws, Np, Mpad, W, gop, gep, a_exgl, a_exgr, b_exgl,
      b_exgr, ends);
  return (int)cudaGetLastError();
}

int spliced_tb_walk(const unsigned char* flags, const int* spj,
                    const int* ends, const int* lws, int B, int L, int S,
                    int T, int IT, int* recs, cudaStream_t stream) {
  const int threads = 32;
  tb_walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      flags, spj, ends, lws, B, L, S, T, IT, recs);
  return (int)cudaGetLastError();
}

}  // extern "C"
