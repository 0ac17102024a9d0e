// Native runtime components (C ABI, loaded via ctypes).
//
// The reference's hot host-side loops are C++ (index build
// blksrc.cc:403-531 Chash::countBlk/registBlk over genome k-mers with a
// thread pipeline, blksrc.cc:1419-1692; FASTA reading seq.cc).  The TPU
// port keeps the device DP in XLA/Pallas but gives the host runtime the
// same native treatment: a parallel two-pass k-mer -> block CSR builder
// and a FASTA byte-stream encoder.  The protein path's top row
// (tron_init_row) is a serial recurrence over the whole genome window,
// so it runs here as one pass too, and so does the splice-signal PSSM
// scan (pssm_scan), which numpy could only do through (L, cols) gathers.
//
// Build: make -C spaln_tpu_torch/native   (g++ -O3 -shared -fPIC,
// std::thread)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------- fasta encode
// Encode FASTA text into nt codes (seq.cc:56 alphabet) in one pass.
// Returns number of sequences found; fills codes (caller-sized >= text
// length), per-seq offsets into codes, and name spans into the text.
int64_t fasta_encode(const char* text, int64_t n, int8_t* codes,
                     int64_t* seq_off, int64_t* name_beg,
                     int64_t* name_end, int64_t max_seqs,
                     const int8_t* enc_tab, int64_t* out_len) {
    int64_t nseq = 0, w = 0;
    int64_t i = 0;
    while (i < n) {
        if (text[i] == '>') {
            if (nseq >= max_seqs) break;
            int64_t b = ++i;
            while (i < n && text[i] != '\n' && text[i] != ' '
                   && text[i] != '\t') ++i;
            name_beg[nseq] = b;
            name_end[nseq] = i;
            while (i < n && text[i] != '\n') ++i;
            seq_off[nseq++] = w;
        } else {
            unsigned char c = (unsigned char)text[i];
            if (c > ' ') codes[w++] = enc_tab[c];
            ++i;
        }
        if (i < n && text[i] == '\n') ++i;
    }
    *out_len = w;
    return nseq;
}

// ------------------------------------------------- k-mer -> block CSR
// Two-pass count/fill (Chash::countBlk/registBlk role) parallelized over
// genome slices; dedups (word, block) pairs by remembering the last
// block registered per word within a pass (valid because positions are
// scanned in order within each slice and blocks are position-monotone).
struct CsrScratch {
    std::vector<std::atomic<int64_t>> counts;
};

// pass 1: per-word unique-block counts.  red: reduced codes (0..3, >=4 =
// ambiguous).  Returns total pairs.
int64_t kmer_csr(const int8_t* red, int64_t n, int32_t k, int32_t blklen,
                 int64_t* offsets /* 4^k + 1, zeroed */,
                 int32_t* blocks /* out, sized by caller after pass 1 */,
                 int32_t two_pass_fill, int32_t nthreads) {
    const int64_t nwords = (int64_t)1 << (2 * k);
    const int64_t mask = nwords - 1;
    if (n < k) return 0;
    const int64_t npos = n - k + 1;

    // scan phase: each thread slices the genome and radix-buckets its
    // (word, block) pairs by high word bits, so the merge phase can run
    // one thread per word range with no synchronization (the reference
    // harvests slices serially, blksrc.cc:1485; here both phases scale)
    if (nthreads < 1) nthreads = 1;
    int nb = 1;
    while (nb < 4 * nthreads && nb < 256 && (int64_t)nb < nwords) nb <<= 1;
    const int bshift = 2 * k - __builtin_ctz(nb);
    std::vector<std::vector<std::vector<std::pair<int64_t,int32_t>>>>
        parts(nthreads);
    std::vector<std::thread> ths;
    int64_t chunk = (npos + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        ths.emplace_back([&, t]() {
            int64_t lo = t * chunk;
            int64_t hi = lo + chunk < npos ? lo + chunk : npos;
            if (lo >= hi) return;
            auto& out = parts[t];
            out.resize(nb);
            for (auto& v : out) v.reserve((hi - lo) / (2 * nb) + 8);
            int64_t w = 0;
            int bad = k;            // bases until word valid again
            // warm up k-1 bases before lo
            for (int64_t p = lo; p < hi + k - 1 && p < n; ++p) {
                int8_t c = red[p];
                w = ((w << 2) | (c & 3)) & mask;
                bad = (c >= 4) ? k : (bad > 0 ? bad - 1 : 0);
                int64_t pos = p - k + 1;
                if (pos < lo || pos >= hi) continue;
                if (bad > 0) continue;
                out[w >> bshift].emplace_back(w, (int32_t)(pos / blklen));
            }
        });
    }
    for (auto& th : ths) th.join();

    // merge phase: one thread per word-range bucket; per-word last-block
    // dedup stays valid because every word lives in exactly one bucket
    // and parts are visited in genome order
    std::vector<int64_t> totals(nb, 0);
    std::vector<std::thread> mths;
    std::vector<int64_t> cursor;
    if (two_pass_fill) {
        cursor.resize(nwords);
        for (int64_t i2 = 0; i2 < nwords; ++i2) cursor[i2] = offsets[i2];
    }
    for (int b0 = 0; b0 < nb; ++b0) {
        mths.emplace_back([&, b0]() {
            const int64_t wlo = (int64_t)b0 << bshift;
            const int64_t whi = (int64_t)(b0 + 1) << bshift;
            std::vector<int32_t> last(whi - wlo, -1);
            int64_t tot = 0;
            for (int t = 0; t < nthreads; ++t) {
                if ((int)parts[t].size() <= b0) continue;
                for (auto& pb : parts[t][b0]) {
                    if (last[pb.first - wlo] == pb.second) continue;
                    last[pb.first - wlo] = pb.second;
                    if (two_pass_fill)
                        blocks[cursor[pb.first]++] = pb.second;
                    else
                        offsets[pb.first + 1]++;
                    ++tot;
                }
            }
            totals[b0] = tot;
        });
        if ((int)mths.size() >= nthreads) {
            for (auto& th : mths) th.join();
            mths.clear();
        }
    }
    for (auto& th : mths) th.join();
    int64_t total = 0;
    for (int b0 = 0; b0 < nb; ++b0) total += totals[b0];
    if (!two_pass_fill)
        for (int64_t i2 = 0; i2 < nwords; ++i2)
            offsets[i2 + 1] += offsets[i2];
    return total;
}

// ------------------------------------------------------ tron init row
// The protein path's top row over n = 0..N+1 (tron_init_row,
// ops/dp_tron.py; initH_ng's free-end mode): H and its direction, each
// column the best of HORI (3 nt back, + gep + sigE[n-3]), HOR1 (1 nt,
// + w1) and HOR2 (2 nt, + w2), reseeded (DEAD) where the translation
// start signal max(sigS[n+1], 0) is higher.  The comparisons are the
// Python loop's, strict and in its order, so ties fall the same way.
// sigS reads 0 outside [0, min(N, s_cut)) (s_cut: the TransInit cut),
// sigE outside [0, N).  H runs in int64 and is stored cast to int32; with
// a_exgl == 0 the row is 0 and DEAD throughout.
void tron_init_row(const int32_t* sigS, const int32_t* sigE, int64_t N,
                   int64_t s_cut, int32_t a_exgl, int64_t gep, int64_t w1,
                   int64_t w2, int32_t* h, int32_t* hd) {
    enum : int32_t { DEAD = 0, HORI = 8, HOR1 = 9, HOR2 = 10 };  // aln.h
    const int64_t s_end = s_cut < N ? s_cut : N;
    auto seed = [&](int64_t n) -> int64_t {
        return (n < s_end && sigS[n] > 0) ? sigS[n] : 0;   // n >= 1 here
    };
    int64_t h1 = 0, h2 = 0, h3 = 0;              // H at n-1, n-2, n-3
    for (int64_t n = 0; n < N + 2; ++n) {
        int64_t v = 0;
        int32_t d = DEAD;
        if (a_exgl) {
            if (n < 3) {
                v = seed(n + 1);
            } else {
                v = h3 + gep + (n - 3 < N ? sigE[n - 3] : 0);
                d = HORI;
                if (h1 + w1 > v) { v = h1 + w1; d = HOR1; }
                if (h2 + w2 > v) { v = h2 + w2; d = HOR2; }
                const int64_t x = seed(n + 1);
                if (v < x) { v = x; d = DEAD; }
            }
        }
        h[n] = (int32_t)v;
        hd[n] = d;
        h3 = h2; h2 = h1; h1 = v;
    }
}

}  // extern "C"

// ------------------------------------------------------------ pssm scan
// numpy's float32 sum along a contiguous row (pairwise_sum, numpy's
// loops_utils.h): under 8 terms left to right; up to 128, eight lanes
// seeded with terms 0-7, each further block of 8 added lane-wise, the
// lanes combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the rest
// in order; past 128 the two halves, cut at a multiple of 8, apart.  The
// reduction adds the result to its identity, 0.
static float pairwise_sum(const float* a, int64_t n) {
    if (n < 8) {
        float res = 0.0f;
        for (int64_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3]))
                    + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// The window score of every position p of codes[0, L) (PatMat::calcPatMat;
// scan_pssm_plain in score/pssm.py holds the same arithmetic in numpy, and
// this pass equals it bit for bit).  Each code is reduced through tab
// (NT_REDUCE4 or TRON_REDUCE4, ntab entries, negative codes from its end).
// The window of p starts at p - offset; its column m reads bases m to
// m + ord (ord = morder, 2 past 2).  A base off either end reads 0 and
// is bad, as is a reduced code >= nalpha.  Order 0 and 1 add mtx[m][ctx]
// for the columns before the first that reads a bad base (ctx clipped to
// the rows) and, order 1, the first base's marginal mtx[0][b0] if it is
// good; order 2 adds every column's mtx[m][16 b0 + 4 b1 + b2 + 20], then
// the m = 0 marginals, or takes cols * min_elem (rounded from double) if
// any column reads a bad base.  Every sum runs in float32 in numpy's
// order; tonic is added last.  mtx: (cols, rows) float32, row-major.
// Returns 0, or -1 where numpy would raise IndexError: a code outside the
// table or, order 0 and 1, a reduced code a gather reads past the rows.
template <int ord>
static int32_t pssm_scan_ord(const int8_t* codes, int64_t L,
                             const int8_t* tab, int32_t ntab,
                             const float* mtx, int32_t cols, int32_t rows,
                             int32_t nalpha, int64_t offset, double min_elem,
                             double tonic, float* out) {
    // padded so that every column of every window lies inside: index
    // i holds base i - lo
    const int64_t lo = offset > 0 ? offset : 0;
    const int64_t hi = cols + ord > offset ? cols + ord - offset : 0;
    const int64_t n = lo + L + hi;         // >= cols + ord
    std::vector<int8_t> val(n, 0);
    std::vector<uint8_t> bad(n, 1);
    for (int64_t i = 0; i < L; ++i) {
        int32_t c = codes[i];
        if (c < 0) c += ntab;
        if (c < 0 || c >= ntab) return -1;
        val[lo + i] = tab[c];
        bad[lo + i] = tab[c] >= nalpha;
    }
    // each column start's context row, and whether it reads a bad base
    const int64_t nc = n - ord;
    std::vector<int32_t> ctx(nc);
    std::vector<uint8_t> cbad(nc);
    for (int64_t i = 0; i < nc; ++i) {
        const int8_t* v = val.data() + i;
        const uint8_t* b = bad.data() + i;
        const int32_t c = ord == 0 ? v[0]
                          : ord == 1 ? nalpha * v[0] + v[1] + nalpha
                          : 16 * v[0] + 4 * v[1] + v[2] + 20;
        ctx[i] = c < rows ? c : rows - 1;
        cbad[i] = b[0] || (ord > 0 && b[1]) || (ord > 1 && b[2]);
    }
    // numpy gathers unclipped the bases of order 0's columns and order
    // 1's first base, and raises for a row past the table
    const int64_t first = lo - offset;
    const int64_t last = first + L - 1 + (ord == 0 ? cols - 1 : 0);
    for (int64_t i = first; ord < 2 && i <= last; ++i)
        if (val[i] >= rows) return -1;
    // first bad column at or after i (orders 0 and 1), or the count of
    // bad columns before i (order 2)
    std::vector<int64_t> nxt(nc + 1, nc);
    for (int64_t i = nc - 1; i >= 0; --i)
        nxt[i] = ord == 2 ? nxt[i + 1] + cbad[i] : cbad[i] ? i : nxt[i + 1];
    const float tonic_f = (float)tonic;
    const float bad_total = (float)((double)cols * min_elem);
    std::vector<float> terms(cols);
    for (int64_t p = 0; p < L; ++p) {
        const int64_t s = p - offset + lo;
        float total;
        if (ord < 2) {
            const int64_t good = nxt[s] - s;
            for (int32_t m = 0; m < cols; ++m)
                terms[m] = m < good ? mtx[(int64_t)m * rows + ctx[s + m]]
                                    : 0.0f;
            total = 0.0f + pairwise_sum(terms.data(), cols);
            if (ord == 1) total += bad[s] ? 0.0f : mtx[val[s]];
        } else if (nxt[s] != nxt[s + cols]) {
            total = bad_total;
        } else {
            for (int32_t m = 0; m < cols; ++m)
                terms[m] = mtx[(int64_t)m * rows + ctx[s + m]];
            total = 0.0f + pairwise_sum(terms.data(), cols);
            total += mtx[val[s] < 3 ? val[s] : 3];
            const int32_t c1 = 4 * val[s] + val[s + 1] + 4;
            total += mtx[c1 < rows ? c1 : rows - 1];
        }
        out[p] = total + tonic_f;
    }
    return 0;
}

extern "C" int32_t pssm_scan(const int8_t* codes, int64_t L,
                             const int8_t* tab, int32_t ntab,
                             const float* mtx, int32_t cols, int32_t rows,
                             int32_t nalpha, int32_t morder, int64_t offset,
                             double min_elem, double tonic, float* out) {
    auto scan = morder == 0 ? pssm_scan_ord<0>
                : morder == 1 ? pssm_scan_ord<1> : pssm_scan_ord<2>;
    return scan(codes, L, tab, ntab, mtx, cols, rows, nalpha, offset,
                min_elem, tonic, out);
}
