/* Frozen copy of the port's host C engine: the benchmark's reference. */
/*
 * mpnative — native host runtime for miniprot_tpu.
 *
 * This library provides the host-side kernels of the TPU-native
 * aligner: the anchor chainer, the striped splice/frameshift DP, the
 * permutation-exact sorter, sketching and per-alignment statistics.
 * The TPU Pallas kernels (miniprot_tpu/kernels/) are the performance
 * path; this library is the correctness anchor and host fallback.
 *
 * PROVENANCE.  The project's acceptance bar is output *byte-parity*
 * with reference miniprot v0.18.  That bar pins more than arithmetic:
 * it pins evaluation orders (the DP traceback word records which of ten
 * candidates won a saturating int16 max, in a fixed order), an unstable
 * sorter's equal-key permutation (which feeds downstream tie-breaking),
 * and float32 rounding (the chain gap penalty and the extension
 * length penalty).  Each function below is labelled with one of:
 *
 *   [original]      new design; the reference is cited only as the
 *                   behavioral spec being matched.
 *   [pinned]        the *algorithm itself* is forced by byte-parity
 *                   (a permutation, a bit layout, or float rounding);
 *                   the label says what pins it and cites the
 *                   reference file:line it must stay equivalent to.
 *                   These are re-expressions of a fixed algorithm —
 *                   they cannot be algorithmically different and
 *                   remain byte-compatible.
 *   [pinned-order]  the computation order is forced (e.g. the DP
 *                   state-update sequence behind the traceback bits)
 *                   but the surrounding organization is ours.
 *
 * Equivalence of every pinned function is fuzz-verified against the
 * reference binary end-to-end (tests/test_fuzz_vs_ref.py, tools/soak.py)
 * and at function level (tests/test_native.py).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <assert.h>
#include <pthread.h>

#define MX_EXPORT __attribute__((visibility("default")))

/* Keep freed heap pages in-process instead of returning them to the
 * kernel: index build and mapping cycle multi-10MB buffers, and on
 * fault-slow virtualized hosts re-faulting returned pages costs far
 * more than the RSS it saves.  (mallopt is glibc-specific; guarded.) */
#if defined(__GLIBC__)
#include <malloc.h>
__attribute__((constructor)) static void mx_malloc_tune(void)
{
	mallopt(M_MMAP_THRESHOLD, 64 << 20);
	mallopt(M_TRIM_THRESHOLD, 64 << 20);
}
#endif

/**************************************
 * Permutation-exact MSD radix sort   *
 **************************************/

/*
 * [pinned]  In-place byte-at-a-time MSD radix sort with cycle-chasing
 * ("American flag") distribution, insertion sort below 64 elements.
 *
 * What pins it: the reference's sorter (ksort.h:112-162) is NOT stable,
 * and the permutation it applies to EQUAL keys leaks into the output:
 * chain candidates with equal scores and regions with equal rank are
 * later tie-broken by array position, so the emitted records depend on
 * this exact permutation.  Replicating the ordering alone is not
 * enough; the algorithm (digit width, small-bucket threshold, the
 * element movement of the distribution pass, and insertion-sort
 * stability) must all produce the same permutation.  The code below
 * re-expresses that fixed algorithm with index-based bucket cursors
 * and an iterative skeleton; it cannot be algorithmically different.
 * Verified by permutation-equality fuzz in tests/test_native.py.
 */

#define MX_RS_MIN 64
#define MX_NBKT 256                /* one byte per MSD level */

typedef struct { uint64_t x, y; } mx_pair_t;

/* Binary insertion would break equal-key order; this shifts only while
 * strictly greater, i.e. it is stable, which is what the reference's
 * small-bucket sorter guarantees. */
#define MX_DEF_INSSORT(name, elem_t, keyof) \
	static void name(elem_t *a, int64_t n) \
	{ \
		int64_t i, j; \
		for (i = 1; i < n; ++i) { \
			elem_t cur = a[i]; \
			if (keyof(cur) >= keyof(a[i - 1])) continue; \
			for (j = i; j > 0 && keyof(cur) < keyof(a[j - 1]); --j) \
				a[j] = a[j - 1]; \
			a[j] = cur; \
		} \
	}

/* One MSD level: count, then chase each displaced element through the
 * bucket cycle until an element belonging to the current bucket lands
 * in the open slot.  `head[c]` is bucket c's next unplaced slot. */
#define MX_DEF_RADIX(name, elem_t, keyof, inssort) \
	static void name(elem_t *a, int64_t n, int sh) \
	{ \
		int64_t head[MX_NBKT], tail[MX_NBKT], start[MX_NBKT]; \
		int64_t i, acc; \
		int c; \
		memset(head, 0, sizeof(head)); \
		for (i = 0; i < n; ++i) ++head[keyof(a[i]) >> sh & 0xff]; \
		for (c = 0, acc = 0; c < MX_NBKT; ++c) { \
			int64_t cnt = head[c]; \
			start[c] = head[c] = acc; \
			acc += cnt; \
			tail[c] = acc; \
		} \
		for (c = 0; c < MX_NBKT; ++c) { \
			while (head[c] < tail[c]) { \
				elem_t x = a[head[c]]; \
				int d = keyof(x) >> sh & 0xff; \
				while (d != c) { \
					elem_t y = a[head[d]]; \
					a[head[d]++] = x; \
					x = y; \
					d = keyof(x) >> sh & 0xff; \
				} \
				a[head[c]++] = x; \
			} \
		} \
		if (sh == 0) return; \
		sh = sh > 8 ? sh - 8 : 0; \
		for (c = 0; c < MX_NBKT; ++c) { \
			int64_t len = tail[c] - start[c]; \
			if (len > MX_RS_MIN) name(a + start[c], len, sh); \
			else if (len > 1) inssort(a + start[c], len); \
		} \
	}

#define mx_key_id(v) (v)
#define mx_key_x(v) ((v).x)

MX_DEF_INSSORT(ins_sort_u64, uint64_t, mx_key_id)
MX_DEF_INSSORT(ins_sort_pair, mx_pair_t, mx_key_x)
MX_DEF_RADIX(rs_pair, mx_pair_t, mx_key_x, ins_sort_pair)

MX_EXPORT void mx_sort_pair(mx_pair_t *a, int64_t n)
{
	if (n <= MX_RS_MIN) ins_sort_pair(a, n);
	else rs_pair(a, n, 56);
}

/************
 * Chaining *
 ************/

/* [pinned]  Fast float32 log2 approximation.  Chain gap penalties and
 * the extension length penalty are computed through this function and
 * truncated to int, so its exact polynomial (three magic constants,
 * float32 rounding at every step) decides scores near the truncation
 * boundaries: a correctly-rounded log2f would change output bytes.
 * Must stay arithmetic-identical to mp_log2 (mppriv.h:91-99). */
static inline float mx_log2f(float x) /* valid for x >= 2 */
{
	union { float f; uint32_t i; } z = { x };
	float log_2 = ((z.i >> 23) & 255) - 128;
	z.i &= ~(255u << 23);
	z.i += 127u << 23;
	log_2 += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
	return log_2;
}

#define MX_NEG_INF (-0x7fffffff - 1)
#define MX_BLOCK_BONUS 2

/*
 * Anchor chaining.  [pinned-order] throughout this section: the scoring
 * arithmetic (float32 penalties truncated to int; behavioral spec in
 * SURVEY §2.1 / paper Eq.1-3, parity target chain.c:112-151) and the
 * max_skip / max_iter / rescue heuristics decide WHICH chains exist,
 * and the heuristics are order-dependent (they depend on the descending
 * predecessor scan and on marks left by earlier anchors), so their
 * decision sequence must match the reference's (chain.c:160-219) even
 * though the code organization here — config struct, split cost
 * helpers, single-pass chain emission — is our own.
 */

typedef struct {
	int32_t max_dist_x, max_dist_y, bw, kmer, bbit;
	int32_t is_spliced;
	float coef_log;
} mx_chain_cfg_t;

/* Integer cost of a gap: linear vs logarithmic parts in float32, then
 * C truncation.  Intron-like gaps (genome side longer, spliced mode)
 * pay the cheaper of the two; everything else pays both. */
static inline int32_t mx_gap_cost(int32_t gap, int32_t sgap, float coef_log, int32_t is_spliced)
{
	float lin = (float)gap * .33334f;
	float lg = gap >= 2 ? coef_log * (mx_log2f(gap + 1) - 1.0f) + 1.0f : (float)gap;
	if (is_spliced && sgap < 0)
		return (int32_t)(lin < lg ? lin : lg);
	return (int32_t)(lin + lg);
}

/* Transition score for chaining `prev` -> `cur` (both pos<<32|qpos).
 * Returns MX_NEG_INF when the pair cannot be chained. */
static inline int32_t mx_pair_sc(const mx_chain_cfg_t *c, uint64_t cur, uint64_t prev)
{
	int32_t dq = (int32_t)cur - (int32_t)prev;  /* query aa advance */
	int32_t dq3 = dq * 3;
	int32_t gap, sgap, credit;
	if (dq <= 0 || dq3 > c->max_dist_x || dq > c->max_dist_y) return MX_NEG_INF;
	if (c->bbit > 0) {
		/* block resolution: genome distance known to one 2^bbit block,
		 * so the gap is the smallest distance consistent with it */
		int32_t bs = 1 << c->bbit;
		int32_t dr3 = (int32_t)(((cur >> 32) - (prev >> 32)) << c->bbit);
		if (dq3 < dr3 - bs)      gap = dr3 - bs - dq3, sgap = -gap;
		else if (dq3 > dr3 + bs) gap = dq3 - (dr3 + bs), sgap = gap;
		else                     gap = sgap = 0;
		if (gap > c->bw) return MX_NEG_INF;
		credit = dq < c->kmer ? dq : c->kmer;
		if (gap == 0 && (cur >> 32) == (prev >> 32))
			credit += MX_BLOCK_BONUS;  /* same-block pair */
	} else {
		/* base resolution: exact genome distance, frameshift-aware */
		int32_t dr3 = (int32_t)((cur >> 32) - (prev >> 32));
		if (dr3 == 0) return MX_NEG_INF;
		sgap = dq3 - dr3;
		gap = sgap < 0 ? -sgap : sgap;
		if (gap > c->bw) return MX_NEG_INF;
		if (c->kmer <= dq && c->kmer * 3 <= dr3) {
			credit = c->kmer;
		} else {
			int32_t diag = dr3 / 3 < dq ? dr3 / 3 : dq;
			credit = diag < c->kmer ? diag : c->kmer;
			if (dr3 % 3 != 0) --credit;  /* out-of-frame step */
		}
	}
	if (gap > 0) credit -= mx_gap_cost(gap, sgap, c->coef_log, c->is_spliced);
	return credit;
}

/* Walk back from candidate peak cand[k] following pred[] links until the
 * score drop from the best suffix seen exceeds max_drop, or the walk
 * runs into an anchor already claimed by another chain.  Returns the
 * link at which the emitted chain should stop (exclusive).  Claim marks
 * (seen=2) are provisional and reset before returning. */
static int64_t mx_chain_stop(int32_t max_drop, const mx_pair_t *cand, int64_t k,
                             const int32_t *score, const int64_t *pred, int32_t *seen)
{
	int64_t i = cand[k].y, walked_to = -1, stop_at = i;
	int32_t best_suffix = 0;
	if (i < 0 || seen[i] != 0) return i;
	for (;;) {
		int32_t suffix;
		seen[i] = 2;
		walked_to = i = pred[i];
		suffix = i < 0 ? (int32_t)cand[k].x : (int32_t)cand[k].x - score[i];
		if (suffix > best_suffix) best_suffix = suffix, stop_at = i;
		else if (best_suffix - suffix > max_drop) break;
		if (i < 0 || seen[i] != 0) break;
	}
	for (i = cand[k].y; i >= 0 && i != walked_to; i = pred[i])
		seen[i] = 0;
	return stop_at;
}

/*
 * Chain anchors a[0..n) (sorted u64 = pos<<32|qpos).  Writes the selected
 * chains' anchors to out_a (capacity n) and score<<32|cnt records to
 * out_u (capacity n); chains ordered by target start.  Returns the
 * number of chains; *n_a_out gets the total anchors written.
 */
MX_EXPORT int64_t mx_chain(int32_t max_dist_x, int32_t max_dist_y, int32_t bw, int32_t max_skip,
                           int32_t max_iter, int32_t min_cnt, int32_t min_sc, float coef_log,
                           int32_t is_spliced, int32_t kmer, int32_t bbit,
                           int64_t n, const uint64_t *a,
                           uint64_t *out_a, uint64_t *out_u, int64_t *n_a_out)
{
	mx_chain_cfg_t cfg;
	int32_t *score, *seen, *picked, max_drop, r_sc = 0;
	int64_t *pred, i, j, lo = 0, r_at = -1, n_cand, k, n_v, n_u;
	mx_pair_t *cand, *order;
	uint64_t *pool, *chn, *chn2;

	*n_a_out = 0;
	if (n == 0) return 0;
	cfg.bw = bw, cfg.kmer = kmer, cfg.bbit = bbit;
	cfg.coef_log = coef_log, cfg.is_spliced = is_spliced;
	cfg.max_dist_x = max_dist_x > bw ? max_dist_x : bw;
	cfg.max_dist_y = !is_spliced && max_dist_y < bw ? bw : max_dist_y;
	max_drop = is_spliced ? 0x7fffffff : bw;
	pred = (int64_t*)malloc(n * 8);
	score = (int32_t*)malloc(n * 4);
	picked = (int32_t*)malloc(n * 4);
	seen = (int32_t*)calloc(n, 4);

	/* Forward DP over anchors.  `seen[x] == i` marks "x was already the
	 * chosen predecessor of some anchor examined while scanning i" —
	 * hitting max_skip of those in a row ends the scan early.  The
	 * rescue pair (r_sc, r_at) remembers the best chain end so far so a
	 * skip-truncated scan can still link to it. */
	for (i = 0; i < n; ++i) {
		int64_t best_j = -1;
		int32_t best = kmer, n_skip = 0;
		while (lo < i && ((a[i] >> 32) - (a[lo] >> 32)) << bbit > (uint64_t)cfg.max_dist_x)
			++lo;
		if (r_at >= lo && r_at >= 0) {
			int32_t sc = r_sc + mx_pair_sc(&cfg, a[i], a[r_at]);
			if (sc > best) best = sc, best_j = r_at;
		} else {
			r_sc = 0, r_at = -1;
		}
		/* NB: the max_iter clamp moves the window start itself (it
		 * persists into later anchors' windows and rescue checks) */
		if (i - lo > max_iter) lo = i - max_iter;
		for (j = i - 1; j >= lo; --j) {
			int32_t sc = mx_pair_sc(&cfg, a[i], a[j]);
			if (sc != MX_NEG_INF) {
				sc += score[j];
				if (sc > best) {
					best = sc, best_j = j;
					if (n_skip > 0) --n_skip;
				} else if (seen[j] == (int32_t)i && ++n_skip > max_skip) {
					break;
				}
				if (pred[j] >= 0) seen[pred[j]] = i;
			}
		}
		score[i] = best, pred[i] = best_j;
		/* picked[] doubles as the peak-score array during the DP */
		picked[i] = best_j >= 0 && picked[best_j] > best ? picked[best_j] : best;
		if (r_sc < best) r_sc = best, r_at = i;
	}

	/* Candidate peaks, ascending score; emit chains greedily from the
	 * highest peak down, claiming anchors as they are consumed. */
	for (i = 0, n_cand = 0; i < n; ++i)
		if (score[i] >= min_sc) ++n_cand;
	if (n_cand == 0) { free(pred); free(score); free(picked); free(seen); return 0; }
	cand = (mx_pair_t*)malloc(n_cand * sizeof(mx_pair_t));
	for (i = 0, k = 0; i < n; ++i)
		if (score[i] >= min_sc) cand[k].x = score[i], cand[k++].y = i;
	mx_sort_pair(cand, n_cand);

	chn = (uint64_t*)malloc(n_cand * 8); /* at most n_cand chains */
	memset(seen, 0, n * 4);
	for (k = n_cand - 1, n_v = n_u = 0; k >= 0; --k) {
		int64_t v0 = n_v, stop_at;
		int32_t sc;
		if (seen[cand[k].y] != 0) continue;
		stop_at = mx_chain_stop(max_drop, cand, k, score, pred, seen);
		for (i = cand[k].y; i != stop_at; i = pred[i])
			picked[n_v++] = i, seen[i] = 1;
		sc = i < 0 ? (int32_t)cand[k].x : (int32_t)cand[k].x - score[i];
		if (sc >= min_sc && n_v - v0 >= min_cnt && n_v > v0)
			chn[n_u++] = (uint64_t)sc << 32 | (n_v - v0);
		else n_v = v0;  /* too short / too weak: unemit (marks stay) */
	}
	free(cand);
	if (n_u == 0) { free(pred); free(score); free(picked); free(seen); free(chn); return 0; }

	/* picked[] holds each chain's anchors peak-first; materialize them
	 * start-first into pool[], then order whole chains by target start. */
	pool = (uint64_t*)malloc(n_v * 8);
	for (i = 0, k = 0; i < n_u; ++i) {
		int64_t base = k, len = (int32_t)chn[i];
		for (j = 0; j < len; ++j)
			pool[k++] = a[picked[base + (len - 1 - j)]];
	}
	order = (mx_pair_t*)malloc(n_u * sizeof(mx_pair_t));
	for (i = k = 0; i < n_u; ++i) {
		order[i].x = pool[k] >> 32;           /* first anchor's position */
		order[i].y = (uint64_t)k << 32 | i;   /* pool offset | chain id */
		k += (int32_t)chn[i];
	}
	mx_sort_pair(order, n_u);
	chn2 = (uint64_t*)malloc(n_u * 8);
	for (i = k = 0; i < n_u; ++i) {
		int64_t id = (int32_t)order[i].y, len = (int32_t)chn[id];
		chn2[i] = chn[id];
		memcpy(&out_a[k], &pool[order[i].y >> 32], len * 8);
		k += len;
	}
	memcpy(out_u, chn2, n_u * 8);
	*n_a_out = n_v;
	free(pred); free(score); free(picked); free(seen); free(chn); free(pool); free(order); free(chn2);
	return n_u;
}

/* ungapped chain score at base resolution; hit.c:18-30 */
static int32_t mx_chn_sc_ungap(int64_t n_a, const uint64_t *a, int32_t kmer)
{
	int64_t i;
	int32_t x = kmer;
	for (i = 1; i < n_a; ++i) {
		const uint64_t a0 = a[i - 1], a1 = a[i];
		int32_t dq = (int32_t)a1 - (int32_t)a0, dr3 = (a1 >> 32) - (a0 >> 32);
		int32_t dr = dr3 / 3, q = dr3 - dr * 3, dg;
		dg = dq < dr ? dq : dr;
		if (dq >= dr && q != 0) --x;
		else x += dg < kmer ? dg : kmer;
	}
	return x;
}

/* block-resolution ungapped chain score; hit.c:6-16 */
static int32_t mx_chn_sc_ungap_approx(int64_t n_a, const uint64_t *a, int32_t kmer)
{
	int64_t i;
	int32_t x = kmer;
	for (i = 1; i < n_a; ++i) {
		const uint64_t a0 = a[i - 1], a1 = a[i];
		int32_t dq = (int32_t)a1 - (int32_t)a0;
		x += dq < kmer ? dq : kmer;
		if (a1 >> 32 == a0 >> 32) x += MX_BLOCK_BONUS;
	}
	return x;
}

/* [original] batch form over one block's chains: reg_gen scores ~250
 * regions per query, and the per-call ctypes overhead of the scalar
 * entry was measurable (~3.5us x 127k calls on the capstone profile) */
MX_EXPORT void mx_chn_sc_ungap_approx_batch(int64_t n_chains,
					    const int64_t *ks,
					    const int64_t *cnts,
					    const uint64_t *a, int32_t kmer,
					    int32_t *out)
{
	int64_t c;
	for (c = 0; c < n_chains; ++c)
		out[c] = mx_chn_sc_ungap_approx(cnts[c], a + ks[c], kmer);
}

/*
 * [pinned] primary/secondary assignment by query overlap
 * (mp_set_parent, hit.c:128-187).  Ported from the byte-parity-tested
 * Python (hits.set_parent — ~1s of pure-Python loop per 500 capstone
 * queries); the overlap ratio is float arithmetic exactly as
 * hit.c:168 (this file builds with -ffp-contract=off).  Region fields
 * arrive flattened; has_p marks regions carrying an alignment (r->p),
 * p_dp_max its dp_max.  parent/n_sub/subsc/p_dp_max2 are read-write
 * (callers pass the regions' current values and copy back).  wbuf and
 * covbuf are caller-provided scratch of n entries each.
 */
/* [pinned] drop weak/duplicate secondaries (mp_select_sub,
 * hit.c:212-236); float ratio tests exactly as the reference with
 * -ffp-contract=off.  keep[i]=1 marks survivors; the caller filters
 * and re-syncs parents. */
MX_EXPORT void mx_select_sub(int64_t n, float pri_ratio, int32_t min_diff,
			     int32_t best_n,
			     const int64_t *qs, const int64_t *qe,
			     const int64_t *vid, const int64_t *vs,
			     const int64_t *ve,
			     const int32_t *parent, const uint8_t *has_p,
			     const int32_t *p_dp_max, const int32_t *chn_sc,
			     const int32_t *chn_sc_ungap, uint8_t *keep)
{
	int32_t best_ungap = -1, n_2nd = 0;
	int64_t i;
	for (i = 0; i < n; ++i)
		if (chn_sc_ungap[i] > best_ungap) best_ungap = chn_sc_ungap[i];
	for (i = 0; i < n; ++i) {
		int64_t p = parent[i];
		int32_t sci = has_p[i] ? p_dp_max[i] : chn_sc[i];
		int32_t scp = has_p[p] ? p_dp_max[p] : chn_sc[p];
		keep[i] = 0;
		if (p == i) { keep[i] = 1; continue; }
		if (((float)sci >= (float)scp * pri_ratio
		     || sci + min_diff >= scp) && n_2nd < best_n) {
			if (!(qs[i] == qs[p] && qe[i] == qe[p]
			      && vid[i] == vid[p] && vs[i] == vs[p]
			      && ve[i] == ve[p])) {
				keep[i] = 1;
				++n_2nd;
			}
		} else if (!has_p[i] && !has_p[p] && best_ungap > 0
			   && (float)chn_sc_ungap[i]
			      >= (float)best_ungap * pri_ratio
			   && n_2nd < best_n) {
			if (!(qs[i] == qs[p] && qe[i] == qe[p]
			      && vid[i] == vid[p] && vs[i] == vs[p]
			      && ve[i] == ve[p])) {
				keep[i] = 1;
				++n_2nd;
			}
		}
	}
}

MX_EXPORT void mx_set_parent(int64_t n, float mask_level, int32_t mask_len,
			     int32_t sub_diff, int32_t hard_mask_level,
			     const int64_t *qs, const int64_t *qe,
			     const int64_t *vid, const int64_t *vs,
			     const int64_t *ve, const int64_t *cnt,
			     const int32_t *chn_sc, const uint8_t *has_p,
			     const int32_t *p_dp_max,
			     int32_t *parent, int32_t *n_sub,
			     int32_t *subsc, int32_t *p_dp_max2,
			     int64_t *wbuf, uint64_t *covbuf)
{
	int64_t i, nw = 0, k;
	if (n <= 0) return;
	parent[0] = 0;
	wbuf[nw++] = 0;
	for (i = 1; i < n; ++i) {
		int64_t si = qs[i], ei = qe[i];
		int64_t uncov_len = 0;
		int placed = 0;
		if (!hard_mask_level) {
			int64_t nc = 0, x;
			for (k = 0; k < nw; ++k) {
				int64_t j = wbuf[k];
				int64_t sj = qs[j], ej = qe[j];
				uint64_t cs, ce;
				if (ej <= si || sj >= ei) continue;
				cs = (uint64_t)(sj > si ? sj : si);
				ce = (uint64_t)(ej < ei ? ej : ei);
				covbuf[nc++] = (cs << 32) | ce;
			}
			if (nc == 0) {
				parent[i] = (int32_t)i;
				n_sub[i] = 0;
				wbuf[nw++] = i;
				continue;
			}
			for (k = 1; k < nc; ++k) {	/* tiny: insertion sort */
				uint64_t v = covbuf[k];
				int64_t m = k - 1;
				while (m >= 0 && covbuf[m] > v)
					covbuf[m + 1] = covbuf[m], --m;
				covbuf[m + 1] = v;
			}
			x = si;
			for (k = 0; k < nc; ++k) {
				int64_t cs = (int64_t)(covbuf[k] >> 32);
				int64_t ce = (int64_t)(covbuf[k] & 0xFFFFFFFFu);
				if (cs > x) uncov_len += cs - x;
				if (ce > x) x = ce;
			}
			if (ei > x) uncov_len += ei - x;
		}
		for (k = 0; k < nw; ++k) {
			int64_t j = wbuf[k];
			int64_t sj = qs[j], ej = qe[j];
			int64_t mn, mx, ol;
			float ovl;
			if (ej <= si || sj >= ei) continue;
			mn = (ej - sj) < (ei - si) ? (ej - sj) : (ei - si);
			mx = (ej - sj) > (ei - si) ? (ej - sj) : (ei - si);
			if (si < sj) ol = ei < sj ? 0 : (ei < ej ? ei - sj : ej - sj);
			else ol = ej < si ? 0 : (ej < ei ? ej - si : ei - si);
			ovl = (float)ol / mn - (float)uncov_len / mx;
			if (ovl > mask_level && uncov_len <= mask_len) {
				int32_t cnt_sub = 0, sci = chn_sc[i];
				parent[i] = parent[j];
				if (sci > subsc[j]) subsc[j] = sci;
				if (cnt[i] >= cnt[j]) cnt_sub = 1;
				if (has_p[j] && has_p[i]
				    && (vid[j] != vid[i] || vs[j] != vs[i]
					|| ve[j] != ve[i] || ol != mn)) {
					sci = p_dp_max[i];
					if (sci > p_dp_max2[j]) p_dp_max2[j] = sci;
					if (p_dp_max[j] - p_dp_max[i] <= sub_diff)
						cnt_sub = 1;
				}
				if (cnt_sub) ++n_sub[j];
				placed = 1;
				break;
			}
		}
		if (!placed) {
			parent[i] = (int32_t)i;
			n_sub[i] = 0;
			wbuf[nw++] = i;
		}
	}
}

/**********************************************
 * Splice/frameshift-aware striped DP ("nasw") *
 **********************************************/

/*
 * Recurrence (nasw-sse.c:15-22 / paper Eq. 5):
 *   I(i,j) = max{ H(i,j-1) - q, I(i,j-1) } - e
 *   D(i,j) = max{ H(i-3,j) - q, D(i-3,j) } - e
 *   A(i,j) = max{ H(i-1,j)   - r - d(i-1), A(i-1,j) }
 *   B(i,j) = max{ H(i-1,j-1) - r - d(i),   B(i-1,j) }
 *   C(i,j) = max{ H(i-1,j-1) - r - d(i+1), C(i-1,j) }
 *   H(i,j) = max{ H(i-3,j-1)+s(i,j), I, D, A-a(i), B-a(i-2), C-a(i-1),
 *                 H(i-1,j)-f, H(i-2,j)-f, H(i-1,j-1)-f, H(i-2,j-1)-f }
 *
 * The 8-lane striped evaluation order (including the lazy-F fixup loop)
 * determines the traceback bits, so it is reproduced exactly.
 */

#define VL 8                     /* int16 lanes */
typedef int16_t v16 __attribute__((vector_size(16), aligned(16)));

#define NEG16 ((int16_t)0x8000)

#if defined(__SSE2__)
#include <emmintrin.h>
#define V2M(v) ((__m128i)(v))
#define M2V(m) ((v16)(m))
#endif

static inline v16 v_set1(int16_t x) { v16 r = {x, x, x, x, x, x, x, x}; return r; }

/* REF_SAT8 (the benchmark's control build): the same DP with its
 * saturating arithmetic clamped at int8's range instead of int16's */
#if defined(REF_SAT8)
#define SAT_HI 127
#define SAT_LO (-128)
#else
#define SAT_HI 32767
#define SAT_LO (-32768)
#endif

static inline v16 v_sadd(v16 a, v16 b)
{
#if defined(__SSE2__) && !defined(REF_SAT8)
	return M2V(_mm_adds_epi16(V2M(a), V2M(b)));
#else
	v16 r;
	int k;
	for (k = 0; k < VL; ++k) {
		int32_t s = (int32_t)a[k] + b[k];
		r[k] = s > SAT_HI ? SAT_HI : s < SAT_LO ? SAT_LO : (int16_t)s;
	}
	return r;
#endif
}

static inline v16 v_ssub(v16 a, v16 b)
{
#if defined(__SSE2__) && !defined(REF_SAT8)
	return M2V(_mm_subs_epi16(V2M(a), V2M(b)));
#else
	v16 r;
	int k;
	for (k = 0; k < VL; ++k) {
		int32_t s = (int32_t)a[k] - b[k];
		r[k] = s > SAT_HI ? SAT_HI : s < SAT_LO ? SAT_LO : (int16_t)s;
	}
	return r;
#endif
}

static inline v16 v_max(v16 a, v16 b)
{
#if defined(__SSE2__)
	return M2V(_mm_max_epi16(V2M(a), V2M(b)));
#else
	v16 m = a > b;
	return (a & m) | (b & ~m);
#endif
}

/* z |= bit where a > b (elementwise) */
static inline v16 v_orbit_gt(v16 z, v16 a, v16 b, int16_t bit)
{
	return z | ((a > b) & v_set1(bit));
}

/* y = a > b ? val : y */
static inline v16 v_sel_gt(v16 y, v16 a, v16 b, int16_t val)
{
	v16 m = a > b;
	return (m & v_set1(val)) | (~m & y);
}

static inline int v_all_le(v16 a, v16 b) /* all lanes a <= b */
{
#if defined(__SSE2__)
	return !_mm_movemask_epi8(_mm_cmpgt_epi16(V2M(a), V2M(b)));
#else
	int k;
	for (k = 0; k < VL; ++k)
		if (a[k] > b[k]) return 0;
	return 1;
#endif
}

static inline int16_t v_hmax(v16 a)
{
	int16_t m = a[0];
	int k;
	for (k = 1; k < VL; ++k)
		if (a[k] > m) m = a[k];
	return m;
}

/* shift lanes up by one (lane k <- lane k-1), filling lane 0 */
static inline v16 v_shift_up(v16 a, int16_t fill)
{
#if defined(__SSE2__)
	v16 r = M2V(_mm_slli_si128(V2M(a), 2));
	r[0] = fill;
	return r;
#else
	v16 r;
	int k;
	for (k = VL - 1; k > 0; --k) r[k] = a[k - 1];
	r[0] = fill;
	return r;
#endif
}

/* CIGAR ops (nasw.h:33-44) */
#define C_M 0
#define C_I 1
#define C_D 2
#define C_N 3
#define C_F 10
#define C_G 11
#define C_U 12
#define C_V 13

/* [pinned]  Run-length CIGAR append.  The no-merge exception for F/G
 * ops is output-visible (consecutive frameshifts stay separate ops in
 * the PAF cg: string) and must match ns_push_cigar (nasw.h:141-153). */
static int32_t push_cigar(uint32_t *cig, int32_t n, uint32_t op, uint32_t len)
{
	if (n == 0 || op != (cig[n - 1] & 0xf) || op == C_F || op == C_G)
		cig[n++] = len << 4 | op;
	else cig[n - 1] += len << 4;
	return n;
}

/*
 * Splice-site penalty tracks.  [pinned-order]  The signal classes (GT/
 * GTR/GC/AT donors, AG/YAG/AC acceptors, poly-Y bonus window) and the
 * per-class penalties sp[0..5] are the splice model itself — behavioral
 * spec SURVEY §2.1, parity target nasw-sse.c:106-210, model derivation
 * nasw-tab.c:109-129.  The class decision trees below are factored into
 * per-site classifier helpers; what each classifier must RETURN is
 * fixed by the model.  Classes: -1 = consensus-with-context (penalty
 * 0), 0/1/2/4 = indexes into sp[], 3 = non-site.
 */

/* fwd donor site at position i: intron starts at i+1 with bases
 * b[i+1],b[i+2]; b[i] and b[i+3] provide context.  Caller guarantees
 * i+3 < nl. */
static inline int32_t class_donor_fwd(const uint8_t *b, int32_t i)
{
	if (b[i + 1] == 2) {                              /* G. */
		if (b[i + 2] == 3)                            /* GT */
			return (b[i + 3] == 0 || b[i + 3] == 2) ? (b[i] == 2 ? -1 : 4) : 0;
		if (b[i + 2] == 1 && b[i] == 2) return 1;     /* GC after G */
	} else if (b[i + 1] == 0 && b[i + 2] == 3) {
		return 2;                                     /* AT */
	}
	return 3;
}

/* fwd acceptor at i: intron ends with bases b[i-1],b[i] */
static inline int32_t class_acceptor_fwd(const uint8_t *b, int32_t i)
{
	if (b[i - 1] == 0) {
		if (b[i] == 2)                                /* AG */
			return i >= 2 && (b[i - 2] == 1 || b[i - 2] == 3) ? -1 : 0;
		if (b[i] == 1) return 2;                      /* AC */
	}
	return 3;
}

/* pyrimidine-richness bonus over the window upstream of an AG acceptor */
static inline int32_t polyy_pen_fwd(const uint8_t *b, int32_t i, int32_t sp5)
{
	int32_t j, pen = 0;
	for (j = i - 4; j >= 0 && j > i - 7; --j)
		if (b[j] != 1 && b[j] != 3) pen += sp5;
	return pen;
}

/* reversed-genome variants (left extension runs the DP on the reversed
 * sequence, so the acceptor pattern appears reversed in the donor role
 * and vice versa) */
static inline int32_t class_donor_rev(const uint8_t *b, int32_t i)
{
	if (b[i + 1] == 2 && b[i + 2] == 0)               /* GA = reversed AG */
		return (b[i + 3] == 1 || b[i + 3] == 3) ? -1 : 0;
	if (b[i + 1] == 1 && b[i + 2] == 0) return 2;     /* CA = reversed AC */
	return 3;
}

static inline int32_t polyy_pen_rev(const uint8_t *b, int32_t i, int32_t nl, int32_t sp5)
{
	int32_t j, pen = 0;
	for (j = i + 5; j < nl && j < i + 8; ++j)
		if (b[j] != 1 && b[j] != 3) pen += sp5;
	return pen;
}

static inline int32_t class_acceptor_rev(const uint8_t *b, int32_t i, int32_t nl)
{
	if (b[i] == 2) {
		if (b[i - 1] == 3)                            /* TG = reversed GT */
			return i >= 2 && (b[i - 2] == 0 || b[i - 2] == 2)
				? (i + 1 < nl && b[i + 1] == 2 ? -1 : 4) : 0;
		if (b[i - 1] == 1 && i + 1 < nl && b[i + 1] == 1) return 1;  /* CG */
	} else if (b[i - 1] == 3 && b[i] == 0) {
		return 2;                                     /* TA = reversed AT */
	}
	return 3;
}

/* Fold a user --spsc track into the donor/acceptor arrays.  The track
 * value at base i applies to array slot i-1 in forward orientation (the
 * off-by-one is part of the track's position convention); unset (0xff)
 * slots pay the null bonus on both tracks.  [pinned-order]: offsets and
 * the io-derived cap match nasw-sse.c:138-152/189-202. */
static void apply_spsc(const uint8_t *ss, int32_t nl, int32_t io, int32_t sp_null_bonus,
                       int32_t rev, int8_t *donor, int8_t *acceptor)
{
	const int32_t cap = (io + 1) / 2 - 1;
	int32_t i;
	for (i = rev ? 0 : 1; i < nl; ++i) {
		int32_t at = rev ? nl - 1 - i : i - 1;
		int32_t v = (int8_t)(ss[i] >> 1) - 64;
		if (v > cap) v = cap;
		if (ss[i] == 0xff) {
			donor[at] -= sp_null_bonus;
			acceptor[at] -= sp_null_bonus;
		} else if ((ss[i] & 1) ^ (rev ? 1 : 0)) {
			/* acceptor-typed entry (donor-typed when reversed) */
			acceptor[at] -= v;
		} else {
			donor[at] -= v;
		}
	}
}

static void prep_fwd(const uint8_t *nsq, int32_t nl, const uint8_t *nt4, const int32_t *sp,
                     const uint8_t *ss, int32_t io, int32_t sp_null_bonus,
                     uint8_t *nas, int8_t *donor, int8_t *acceptor)
{
	int32_t i;
	for (i = 0; i < nl; ++i) nas[i] = nt4[nsq[i]];
	for (i = 0; i < nl + 1; ++i) donor[i] = acceptor[i] = sp[3];
	for (i = 0; i + 3 < nl; ++i) {
		int32_t c = class_donor_fwd(nas, i);
		donor[i] = c < 0 ? 0 : sp[c];
	}
	for (i = 1; i < nl; ++i) {
		int32_t c = class_acceptor_fwd(nas, i);
		acceptor[i] = c < 0 ? 0 : sp[c];
		if (c <= 0) acceptor[i] += polyy_pen_fwd(nas, i, sp[5]);
	}
	if (ss) apply_spsc(ss, nl, io, sp_null_bonus, 0, donor, acceptor);
}

static void prep_rev(const uint8_t *nsq, int32_t nl, const uint8_t *nt4, const int32_t *sp,
                     const uint8_t *ss, int32_t io, int32_t sp_null_bonus,
                     uint8_t *nas, int8_t *donor, int8_t *acceptor)
{
	int32_t i;
	for (i = 0; i < nl; ++i) nas[nl - 1 - i] = nt4[nsq[i]];
	for (i = 0; i < nl + 1; ++i) donor[i] = acceptor[i] = sp[3];
	for (i = 0; i + 3 < nl; ++i) { /* reversed acceptor plays the donor role */
		int32_t c = class_donor_rev(nas, i);
		donor[i] = c < 0 ? 0 : sp[c];
		if (c <= 0) donor[i] += polyy_pen_rev(nas, i, nl, sp[5]);
	}
	for (i = 1; i < nl; ++i) {
		int32_t c = class_acceptor_rev(nas, i, nl);
		acceptor[i] = c < 0 ? 0 : sp[c];
	}
	if (ss) apply_spsc(ss, nl, io, sp_null_bonus, 1, donor, acceptor);
}

/* [original]  Rolling three-base translation: nas[i] = amino acid of
 * the codon ending at genome position i, X wherever any of the three
 * bases is ambiguous (spec: nasw-sse.c:91-104). */
static void prep_nas(const uint8_t *nsq, int32_t nl, const uint8_t *nt4, const uint8_t *codon_tab,
                     uint8_t aa_x, uint8_t *nas)
{
	int32_t i, l;
	uint8_t codon = 0;
	memset(nas, aa_x, nl);
	for (i = l = 0; i < nl; ++i) {
		uint8_t c = nt4[nsq[i]];
		if (c < 4) {
			codon = (codon << 2 | c) & 0x3f;
			if (++l >= 3) nas[i] = codon_tab[codon];
		} else codon = 0, l = 0;
	}
}

/*
 * Traceback over the striped tb matrix.  [pinned]  The 10-bit cell word
 * is the DP's wire format: bits 0..3 = winning state, bits 4..8 =
 * "stayed in gap state" extension flags, bit 9 = lazy-F overwrite.
 * Both the bit meanings and the striped cell address
 * (stripe = j%slen, lane = j/slen) come from the DP kernel that wrote
 * the matrix, which in turn is pinned to the reference's layout
 * (written nasw-sse.c:444-541, decoded nasw-sse.c:40-89).  The decode
 * below is table-driven rather than an if-chain, but the (state ->
 * op/step) mapping itself cannot differ.
 *
 * row_stride: int16 units between consecutive genome rows (slen*vl for
 * a single-problem matrix; larger when problems are interleaved).
 */

/* per-state step table: genome rows consumed, query aas consumed,
 * CIGAR op, op length.  States 4/5 (U/V introns) consume the query
 * column only when the cell is NOT a gap continuation (handled at the
 * call site via the ext flag). */
static const int8_t bt_step[10][4] = {
	/*  di dj  op   len */
	{ 3, 1, C_M, 1 },   /* 0: codon match        */
	{ 0, 1, C_I, 1 },   /* 1: insertion          */
	{ 3, 0, C_D, 1 },   /* 2: codon deletion     */
	{ 1, 0, C_N, 1 },   /* 3: phase-0 intron     */
	{ 1, 1, C_U, 1 },   /* 4: phase-1 intron     */
	{ 1, 1, C_V, 1 },   /* 5: phase-2 intron     */
	{ 1, 0, C_F, 1 },   /* 6: frameshift del 1   */
	{ 2, 0, C_F, 2 },   /* 7: frameshift del 2   */
	{ 1, 1, C_G, 1 },   /* 8: frameshift match 1 */
	{ 2, 1, C_G, 2 },   /* 9: frameshift match 2 */
};

static int32_t dp_backtrack_st(const int16_t *tb, int32_t slen, int32_t vl,
                               int64_t row_stride, int32_t nl, int32_t al, uint32_t *cig)
{
	int32_t i = nl - 1, j = al - 1, last = 0, n = 0, k;
	while (i >= 2 && j >= 0) {
		int32_t x = tb[(int64_t)i * row_stride + (j % slen) * vl + j / slen];
		int32_t state, ext;
		if (x >> 9 & 1) x = 1 | (x >> 4 << 4);  /* lazy-F overwrote H with I */
		state = last == 0 ? x & 0xf : last;     /* gap runs carry their state */
		ext = state >= 1 && state <= 5 ? x >> (state + 3) & 1 : 0;
		n = push_cigar(cig, n, bt_step[state][2], bt_step[state][3]);
		i -= bt_step[state][0];
		j -= (state == 4 || state == 5) ? !ext : bt_step[state][1];
		last = state >= 1 && state <= 5 && ext ? state : 0;
	}
	/* unreached prefix of either sequence */
	if (j > 0) n = push_cigar(cig, n, C_I, j);
	if (i >= 0) {
		int32_t whole = (i + 1) / 3 * 3, part = (i + 1) % 3;
		if (whole > 0) n = push_cigar(cig, n, C_D, whole);
		if (part != 0) n = push_cigar(cig, n, C_F, part);
	}
	for (k = 0; k < n >> 1; ++k) { /* ops were emitted end-first */
		uint32_t tmp = cig[k];
		cig[k] = cig[n - 1 - k];
		cig[n - 1 - k] = tmp;
	}
	/* a U/V shorter than 3nt cannot be a real intron (possible with
	 * extreme --spsc scores); re-type as frameshift-match so exons
	 * don't overlap.  Parity: nasw-sse.c:30-38. */
	for (k = 0; k < n; ++k) {
		uint32_t op = cig[k] & 0xf;
		if ((op == C_U || op == C_V) && cig[k] >> 4 < 3)
			cig[k] = (cig[k] >> 4 << 4) | C_G;
	}
	return n;
}

static int32_t dp_backtrack_vl(const int16_t *tb, int32_t slen, int32_t vl,
                               int32_t nl, int32_t al, uint32_t *cig)
{
	return dp_backtrack_st(tb, slen, vl, (int64_t)slen * vl, nl, al, cig);
}

static int32_t dp_backtrack(const int16_t *tb, int32_t slen, int32_t nl, int32_t al, uint32_t *cig)
{
	return dp_backtrack_vl(tb, slen, VL, nl, al, cig);
}

#define DPF_CIGAR     0x1
#define DPF_EXT_LEFT  0x2
#define DPF_EXT_RIGHT 0x4

/*
 * The main DP entry (16-bit striped).
 *
 * [pinned-order]  This function's observable outputs — every traceback
 * word, the saturating int16 cell values, the extension end choice —
 * are pinned to the reference kernel's evaluation order
 * (ns_global_gs16b, nasw-sse.c:340-556): the traceback nibble records
 * which of ten candidates won a max computed in a FIXED sequence
 * (match, I, D, A, B, C, then the four frameshift transitions — a
 * different order changes which bits win ties), the stripe layout
 * fixes which cells share a saturating lane, and the lazy-F fixup
 * must revisit stripes in the same order to set bit 9 identically.
 * Within that forced order, the organization here is ours: lane-width-
 * generic gcc vector types (the same body autovectorizes or runs under
 * ASan without intrinsics), grow-only scratch slots instead of an
 * arena, a shared backtrack decoder, an AVX-512 wide path for the
 * layout-free extension mode, and the x4 problem-batched variant.
 *
 * nsq/asq: raw byte strings (any chars; converted via nt4/aa20 tables).
 * ss:      optional per-base splice-score track (0xff = unset), or NULL.
 * cigar:   caller buffer with room for at least nl + al + 16 entries.
 */

/* grow-only scratch for the DP temporaries: mapping makes tens of DP
 * calls per query and per-call malloc + first-touch was a measurable
 * fraction of host map time.  Each thread that enters the engine has
 * its own slots (and mx_sort_u64_lsd's buffer): the GPU pipeline runs
 * seeding and chaining on a producer thread while its pump runs host
 * DPs, so no slot may be shared between threads.  A thread's slots are
 * freed when it exits. */
#define MX_NSLOT 28
typedef struct {
	void *p[MX_NSLOT];
	size_t cap[MX_NSLOT];
	uint64_t *sbuf;          /* mx_sort_u64_lsd's buffer */
	int64_t sbuf_cap;
} mx_scr_t;

static _Thread_local mx_scr_t *mx_tscr;
static pthread_key_t mx_scr_key;
static pthread_once_t mx_scr_once = PTHREAD_ONCE_INIT;

static void mx_scr_release(void *v)
{
	mx_scr_t *s = (mx_scr_t*)v;
	int i;
	for (i = 0; i < MX_NSLOT; ++i) free(s->p[i]);
	free(s->sbuf);
	free(s);
}

static void mx_scr_key_init(void)
{
	pthread_key_create(&mx_scr_key, mx_scr_release);
}

/* the calling thread's scratch set, made on its first use (0 when out
 * of memory) */
static mx_scr_t *mx_scr_get(void)
{
	if (!mx_tscr) {
		pthread_once(&mx_scr_once, mx_scr_key_init);
		mx_tscr = (mx_scr_t*)calloc(1, sizeof(mx_scr_t));
		if (mx_tscr) pthread_setspecific(mx_scr_key, mx_tscr);
	}
	return mx_tscr;
}

static void *mx_scratch(int slot, size_t size)
{
	mx_scr_t *s = mx_scr_get();
	if (!s) return 0;
	if (s->cap[slot] < size) {
		size_t cap = size + size / 2 + 256;
		cap = (cap + 63) & ~(size_t)63;   /* zmm state arrays deref aligned */
		free(s->p[slot]);
		s->p[slot] = aligned_alloc(64, cap);
		s->cap[slot] = s->p[slot] ? cap : 0;
	}
	return s->p[slot];
}

/* Release the calling thread's scratch slots above a byte threshold.
 * The grow-only slots otherwise pin the high-water mark (one
 * 200kb-intron x 1000aa traceback is ~0.4 GB) for the thread's
 * lifetime; the mapper trims between queries so RSS tracks the
 * typical, not the worst, DP. */
MX_EXPORT void mx_scratch_trim(int64_t threshold)
{
	mx_scr_t *s = mx_tscr;
	int i;
	if (!s) return;
	for (i = 0; i < MX_NSLOT; ++i)
		if (s->cap[i] > (size_t)threshold) {
			free(s->p[i]);
			s->p[i] = 0, s->cap[i] = 0;
		}
}



/**************************************************
 * AVX-512BW wide extension path (score-only)     *
 **************************************************/

/* The traceback bit layout pins the CIGAR path to the reference's 8-lane
 * striping, but the score-only extension path is layout-free: the DP
 * cell values are the unique fixpoint of the saturating max-plus
 * recurrence, so any stripe width yields identical scores, end
 * positions and x-drop decisions (the same argument that lets the TPU
 * kernel use a completely different layout).  On AVX-512BW hosts the
 * extension DP runs 32 int16 lanes per op instead of 8. */

#if defined(__x86_64__)
#include <immintrin.h>
#define VLW 32

static int32_t mx_no_wide_ext = 0;   /* test hook: force the 8-lane path */
static int32_t mx_no_x4 = 0;         /* test hook: force per-problem CIGAR */

static int mx_have_avx512bw_raw(void)
{
#if defined(REF_SAT8)
	return 0;   /* the control runs the 8-lane path only */
#endif
	static int c = -1;
	if (c < 0) c = __builtin_cpu_supports("avx512bw");
	return c;
}

static int mx_have_avx512bw(void)
{
	return mx_have_avx512bw_raw() && !mx_no_wide_ext;
}

__attribute__((target("avx512bw")))
static inline __m512i w_shift_up(__m512i a, int16_t fill)
{
	static const uint16_t idx_[VLW] = {
		0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
		16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30 };
	__m512i r = _mm512_permutexvar_epi16(
		_mm512_loadu_si512((const void *)idx_), a);
	return _mm512_mask_set1_epi16(r, 1, fill);
}

__attribute__((target("avx512bw")))
static inline __m512i w_shift_up_n(__m512i a, int32_t d, __m512i fill)
{
	/* shift a up by d 16-bit lanes, filling the low d lanes from fill */
	static const uint16_t base[VLW] = {
		0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
		16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31 };
	__m512i idx = _mm512_sub_epi16(
		_mm512_loadu_si512((const void *)base),
		_mm512_set1_epi16((int16_t)d));
	__mmask32 keep = (__mmask32)(~0u << d);
	return _mm512_mask_permutexvar_epi16(fill, keep, idx, a);
}

__attribute__((target("avx512bw")))
static inline int16_t w_hmax(__m512i a)
{
	__m256i b = _mm256_max_epi16(_mm512_castsi512_si256(a),
	                             _mm512_extracti64x4_epi64(a, 1));
	__m128i c = _mm_max_epi16(_mm256_castsi256_si128(b),
	                          _mm256_extracti128_si256(b, 1));
	c = _mm_max_epi16(c, _mm_srli_si128(c, 8));
	c = _mm_max_epi16(c, _mm_srli_si128(c, 4));
	c = _mm_max_epi16(c, _mm_srli_si128(c, 2));
	return (int16_t)_mm_extract_epi16(c, 0);
}

__attribute__((target("avx512bw")))
static void dp16_ext_w(
	const uint8_t *nas, const int8_t *donor, const int8_t *acceptor,
	const uint8_t *aas, int32_t nl, int32_t al,
	const int8_t *mat, int32_t asize,
	int32_t go_, int32_t ge_, int32_t io_, int32_t fs_,
	int32_t xdrop, int32_t end_bonus, float ie_coef,
	int32_t *out_score, int32_t *out_nt_len, int32_t *out_aa_len)
{
	const int32_t slen = (al + VLW - 1) / VLW;
	int32_t i, j, k;
	int16_t *prof;
	__m512i *buf, *H, *H1, *H2, *H3, *Hmax, *D, *D1, *D2, *D3, *A, *B, *C, *tmpv;
	const __m512i go = _mm512_set1_epi16((int16_t)go_);
	const __m512i ge = _mm512_set1_epi16((int16_t)ge_);
	const __m512i goe = _mm512_set1_epi16((int16_t)(go_ + ge_));
	const __m512i io = _mm512_set1_epi16((int16_t)io_);
	const __m512i fs = _mm512_set1_epi16((int16_t)fs_);
	const __m512i neg = _mm512_set1_epi16(NEG16);
	int32_t max_sc = MX_NEG_INF, max_sc_log = MX_NEG_INF, max_i = -1;
	int32_t tmp_sc, tmp_sc_log, end_sc;
	const int32_t pen_len = al * 3;

	prof = (int16_t*)mx_scratch(4, (size_t)asize * slen * VLW * 2);
	{
		int16_t *t = prof;
		for (i = 0; i < asize; ++i) {
			const int8_t *ma = mat + i * asize;
			for (j = 0; j < slen; ++j)
				for (k = j; k < slen * VLW; k += slen)
					*t++ = k >= al ? NEG16 : ma[aas[k]];
		}
	}
	buf = (__m512i*)mx_scratch(5, ((size_t)(slen + 1) * 5 + (size_t)slen * 7) * 64);
	H = buf + 1, H1 = buf + (slen + 1) + 1, H2 = buf + (slen + 1) * 2 + 1, H3 = buf + (slen + 1) * 3 + 1;
	Hmax = buf + (slen + 1) * 4 + 1;
	D = Hmax + slen, D1 = D + slen, D2 = D1 + slen, D3 = D2 + slen;
	A = D3 + slen, B = A + slen, C = B + slen;
	for (i = 0; i < (slen + 1) * 5 + slen * 7; ++i)
		_mm512_storeu_si512(buf + i, neg);
	((int16_t*)(H3 - 1))[0] = 0;
	((int16_t*)(H2 - 1))[0] = (int16_t)-fs_;
	((int16_t*)(H1 - 1))[0] = (int16_t)-fs_;

	for (i = 2; i < nl; ++i) {
		__m512i I, last_h, maxv, gei;
		const __m512i dim1 = _mm512_set1_epi16(donor[i - 1]);
		const __m512i di = _mm512_set1_epi16(donor[i]);
		const __m512i dip1 = _mm512_set1_epi16(donor[i + 1]);
		const __m512i ai = _mm512_set1_epi16(acceptor[i]);
		const __m512i aim1 = _mm512_set1_epi16(acceptor[i - 1]);
		const __m512i aim2 = _mm512_set1_epi16(acceptor[i - 2]);
		const int16_t *S = prof + (size_t)nas[i] * slen * VLW;
		gei = nas[i] == 20 ? fs : ge;
		I = last_h = neg;
		if (i > 2) {
			H3[-1] = w_shift_up(H3[slen - 1], NEG16);
			H2[-1] = w_shift_up(H2[slen - 1], NEG16);
			H1[-1] = w_shift_up(H1[slen - 1], NEG16);
		}
		maxv = neg;
		for (j = 0; j < slen; ++j) {
			__m512i h, t, u, v, Sv;
			Sv = _mm512_loadu_si512((const void *)(S + (size_t)j * VLW));
			h = _mm512_adds_epi16(H3[j - 1], Sv);
			/* I */
			t = _mm512_subs_epi16(last_h, go);
			t = _mm512_max_epi16(t, I);
			I = _mm512_subs_epi16(t, ge);
			h = _mm512_max_epi16(h, I);
			/* D */
			u = H3[j]; v = D3[j];
			t = _mm512_max_epi16(_mm512_subs_epi16(u, go), v);
			t = _mm512_subs_epi16(t, gei);
			D[j] = t;
			h = _mm512_max_epi16(h, t);
			/* A */
			u = _mm512_subs_epi16(H1[j], io); v = A[j];
			t = _mm512_subs_epi16(u, dim1);
			t = _mm512_max_epi16(t, v);
			A[j] = t;
			h = _mm512_max_epi16(h, _mm512_subs_epi16(t, ai));
			/* B */
			u = _mm512_subs_epi16(H1[j - 1], io); v = B[j];
			t = _mm512_subs_epi16(u, di);
			t = _mm512_max_epi16(t, v);
			B[j] = t;
			h = _mm512_max_epi16(h, _mm512_subs_epi16(t, aim2));
			/* C */
			v = C[j];
			t = _mm512_subs_epi16(u, dip1);
			t = _mm512_max_epi16(t, v);
			C[j] = t;
			h = _mm512_max_epi16(h, _mm512_subs_epi16(t, aim1));
			/* frameshift transitions */
			h = _mm512_max_epi16(h, _mm512_subs_epi16(H1[j], fs));
			h = _mm512_max_epi16(h, _mm512_subs_epi16(H2[j], fs));
			h = _mm512_max_epi16(h, _mm512_subs_epi16(H1[j - 1], fs));
			h = _mm512_max_epi16(h, _mm512_subs_epi16(H2[j - 1], fs));
			maxv = _mm512_max_epi16(maxv, h);
			H[j] = h;
			last_h = h;
		}
		I = _mm512_max_epi16(_mm512_subs_epi16(last_h, goe),
		                     _mm512_subs_epi16(I, ge));
		/* Exact cross-lane I correction, replacing the iterative
		 * lazy-F loop (nasw-sse.c:409-422): lane k of I now holds the
		 * I value entering lane k+1 computed with no cross-lane
		 * carry-in.  The true carry obeys X(k) = max(E(k), X(k-1) -
		 * slen*ge) (a carried insertion decays by ge per position and
		 * a re-open from a carried-correction cell can never beat the
		 * carry itself, since go > 0) — a max-scan with constant
		 * decay, done in log2(VLW) shift-subtract-max steps instead
		 * of up to VLW one-lane wrap passes.  Identical results; the
		 * wrap loop was O(VLW*slen) on insertion-dominated rows
		 * (the xdrop tail of every extension), which made 32 lanes
		 * slower than 8 there. */
		{
			int32_t d, dec = slen * ge_;
			__m512i X = I, carry;
			for (d = 1; d < VLW; d <<= 1) {
				int32_t step = d * dec < 32767 ? d * dec : 32767;
				X = _mm512_max_epi16(X, _mm512_subs_epi16(
					w_shift_up_n(X, d, neg),
					_mm512_set1_epi16((int16_t)step)));
			}
			carry = w_shift_up(X, NEG16);
			for (j = 0; j < slen; ++j) {
				__m512i h = _mm512_max_epi16(H[j], carry);
				maxv = _mm512_max_epi16(maxv, h);
				H[j] = h;
				carry = _mm512_subs_epi16(carry, ge);
				if (!_mm512_cmpgt_epi16_mask(
					carry, _mm512_subs_epi16(h, goe))) break;
			}
		}
		tmp_sc = w_hmax(maxv);
		end_sc = ((int16_t*)H)[(size_t)((al - 1) % slen) * VLW + (al - 1) / slen] + end_bonus;
		tmp_sc = tmp_sc > end_sc ? tmp_sc : end_sc;
		tmp_sc_log = tmp_sc - (i - pen_len < 2 ? 0 : (int32_t)(ie_coef * mx_log2f(i - pen_len) + .5f));
		if (tmp_sc_log > max_sc_log) {
			max_sc = tmp_sc, max_sc_log = tmp_sc_log, max_i = i;
			memcpy(Hmax - 1, H - 1, (size_t)(slen + 1) * 64);
		}
		tmpv = H3, H3 = H2, H2 = H1, H1 = H, H = tmpv;
		tmpv = D3, D3 = D2, D2 = D1, D1 = D, D = tmpv;
		if (max_sc_log - tmp_sc_log > xdrop) break;
	}
	for (j = 0; j < al; ++j) {
		int32_t sc = ((int16_t*)Hmax)[(size_t)(j % slen) * VLW + j / slen];
		if (j == al - 1) sc += end_bonus;
		if (sc == max_sc) break;
	}
	*out_nt_len = max_i + 1, *out_aa_len = j + 1, *out_score = max_sc;
}
/**************************************************************
 * Batched 4-problem CIGAR DP (AVX-512BW, 8-lane semantics)   *
 **************************************************************/

/* The CIGAR traceback bit layout (and the lazy-F pass structure that
 * feeds bit 9) is pinned to the reference's 8-lane striping, so a wider
 * stripe cannot be used for traceback runs.  Instead, four independent
 * DP problems run side by side: problem p occupies 16-bit lanes
 * [8p, 8p+8) of each 512-bit vector, and _mm512_bslli_epi128 reproduces
 * _mm_slli_si128 within each problem's 128-bit sublane exactly.  Each
 * problem keeps its own stripe count slen[p]; stripes j >= slen[p] are
 * masked off so the per-problem I chain, lazy-F passes and traceback
 * bits are bit-identical to running mx_dp16 on that problem alone
 * (fuzz-asserted in tests/test_native.py). */

#define X4 4

__attribute__((target("avx512bw")))
static inline __m512i x4_shift_up128(__m512i a, __m512i fill)
{
	__m512i r = _mm512_bslli_epi128(a, 2);
	return _mm512_mask_mov_epi16(r, (__mmask32)0x01010101u, fill);
}

__attribute__((target("avx512bw")))
static inline __m512i x4_bcast4(const int16_t *v)
{
	/* lanes [8p, 8p+8) <- v[p] */
	static const uint16_t idx_[VLW] = {
		0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
		2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3 };
	__m128i s = _mm_loadl_epi64((const __m128i *)v);
	return _mm512_permutexvar_epi16(
		_mm512_loadu_si512((const void *)idx_),
		_mm512_castsi128_si512(s));
}

__attribute__((target("avx512bw")))
static inline __m512i x4_load4(const int16_t *const *base, size_t off, int32_t n)
{
	__m512i r = _mm512_castsi128_si512(
		_mm_loadu_si128((const __m128i *)(base[0] + off)));
	if (n > 1) r = _mm512_inserti32x4(r,
		_mm_loadu_si128((const __m128i *)(base[1] + off)), 1);
	if (n > 2) r = _mm512_inserti32x4(r,
		_mm_loadu_si128((const __m128i *)(base[2] + off)), 2);
	if (n > 3) r = _mm512_inserti32x4(r,
		_mm_loadu_si128((const __m128i *)(base[3] + off)), 3);
	return r;
}

__attribute__((target("avx512bw")))
static inline __m512i x4_gather_last(const __m512i *X, const int32_t *slen, int32_t n)
{
	/* sublane p <- 128 bits at X's stripe slen[p]-1, problem p's lanes */
	const int16_t *b = (const int16_t *)X;
	__m512i r = _mm512_castsi128_si512(_mm_loadu_si128(
		(const __m128i *)(b + (int64_t)(slen[0] - 1) * VLW)));
	if (n > 1) r = _mm512_inserti32x4(r, _mm_loadu_si128(
		(const __m128i *)(b + (int64_t)(slen[1] - 1) * VLW + 8)), 1);
	if (n > 2) r = _mm512_inserti32x4(r, _mm_loadu_si128(
		(const __m128i *)(b + (int64_t)(slen[2] - 1) * VLW + 16)), 2);
	if (n > 3) r = _mm512_inserti32x4(r, _mm_loadu_si128(
		(const __m128i *)(b + (int64_t)(slen[3] - 1) * VLW + 24)), 3);
	return r;
}

__attribute__((target("avx512bw")))
static void dp16_cig_x4(
	int32_t n, const uint8_t *const *nsqs, const int32_t *nls,
	const uint8_t *const *asqs, const int32_t *als,
	const uint8_t *const *sss,
	const int8_t *mat, int32_t asize,
	const uint8_t *nt4, const uint8_t *aa20, const uint8_t *codon_tab,
	const int32_t *sp, int32_t sp_null_bonus,
	int32_t go_, int32_t ge_, int32_t io_, int32_t fs_,
	int32_t *out_scores, uint32_t *cig_buf, const int64_t *cig_off, int32_t *n_cigs)
{
	const uint8_t aa_x = aa20['X'];
	int32_t p, i, j, k;
	int32_t slen[X4], nl_max = 0, slen_max = 0;
	uint8_t *nas[X4];
	int8_t *donor[X4], *acceptor[X4];
	int16_t *prof[X4];
	const int16_t *Sp[X4];
	__m512i *buf, *H, *H1, *H2, *H3, *D, *D1, *D2, *D3, *A, *B, *C, *tmpv;
	int16_t *tb;
	uint32_t *jmask;
	const __m512i go = _mm512_set1_epi16((int16_t)go_);
	const __m512i ge = _mm512_set1_epi16((int16_t)ge_);
	const __m512i goe = _mm512_set1_epi16((int16_t)(go_ + ge_));
	const __m512i io = _mm512_set1_epi16((int16_t)io_);
	const __m512i fs = _mm512_set1_epi16((int16_t)fs_);
	const __m512i neg = _mm512_set1_epi16(NEG16);

	for (p = 0; p < n; ++p) {
		slen[p] = (als[p] + VL - 1) / VL;
		if (nls[p] > nl_max) nl_max = nls[p];
		if (slen[p] > slen_max) slen_max = slen[p];
	}

	for (p = 0; p < n; ++p) {  /* per-problem prep into padded arrays */
		int32_t nl = nls[p], al = als[p];
		uint8_t *aas = (uint8_t*)mx_scratch(7, al);
		int16_t *t;
		nas[p] = (uint8_t*)mx_scratch(8 + p, nl_max + 8);
		donor[p] = (int8_t*)mx_scratch(12 + p, nl_max + 8);
		acceptor[p] = (int8_t*)mx_scratch(16 + p, nl_max + 8);
		memset(nas[p] + nl, aa_x, nl_max + 8 - nl);
		memset(donor[p] + nl, 0, nl_max + 8 - nl);
		memset(acceptor[p] + nl, 0, nl_max + 8 - nl);
		for (j = 0; j < al; ++j) aas[j] = aa20[asqs[p][j]];
		prep_fwd(nsqs[p], nl, nt4, sp, sss[p], io_, sp_null_bonus,
		         nas[p], donor[p], acceptor[p]);
		prep_nas(nsqs[p], nl, nt4, codon_tab, aa_x, nas[p]);
		prof[p] = (int16_t*)mx_scratch(20 + p, (size_t)asize * slen_max * VL * 2);
		t = prof[p];
		for (i = 0; i < asize; ++i) {
			const int8_t *ma = mat + i * asize;
			for (j = 0; j < slen_max; ++j)
				for (k = 0; k < VL; ++k) {
					int32_t pos = k * slen[p] + j;
					*t++ = (j >= slen[p] || pos >= al) ? NEG16 : ma[aas[pos]];
				}
		}
	}

	jmask = (uint32_t*)mx_scratch(24, (size_t)slen_max * 4);
	for (j = 0; j < slen_max; ++j) {
		uint32_t m = 0;
		for (p = 0; p < n; ++p)
			if (j < slen[p]) m |= 0xffu << (p * 8);
		jmask[j] = m;
	}

	buf = (__m512i*)mx_scratch(5, ((size_t)(slen_max + 1) * 4 + (size_t)slen_max * 7) * 64);
	H = buf + 1, H1 = buf + (slen_max + 1) + 1;
	H2 = buf + (slen_max + 1) * 2 + 1, H3 = buf + (slen_max + 1) * 3 + 1;
	D = buf + (slen_max + 1) * 4, D1 = D + slen_max, D2 = D1 + slen_max, D3 = D2 + slen_max;
	A = D3 + slen_max, B = A + slen_max, C = B + slen_max;
	for (i = 0; i < (slen_max + 1) * 4 + slen_max * 7; ++i)
		_mm512_store_si512(buf + i, neg);
	{
		__mmask32 m0 = (__mmask32)0x01010101u;  /* lane 0 of each problem */
		H3[-1] = _mm512_mask_set1_epi16(H3[-1], m0, 0);
		H2[-1] = _mm512_mask_set1_epi16(H2[-1], m0, (int16_t)-fs_);
		H1[-1] = _mm512_mask_set1_epi16(H1[-1], m0, (int16_t)-fs_);
	}

	tb = (int16_t*)mx_scratch(6, (size_t)nl_max * slen_max * VLW * 2);

	for (i = 2; i < nl_max; ++i) {
		int16_t *tbi = tb + (int64_t)i * slen_max * VLW;
		__m512i I, last_h, gei, dim1, di, dip1, ai, aim1, aim2;
		__mmask32 live = 0;
		int16_t v4[7][X4] = {{0}};
		for (p = 0; p < n; ++p) {
			if (i < nls[p]) live |= (__mmask32)0xffu << (p * 8);
			v4[0][p] = donor[p][i - 1];
			v4[1][p] = donor[p][i];
			v4[2][p] = donor[p][i + 1];
			v4[3][p] = acceptor[p][i];
			v4[4][p] = acceptor[p][i - 1];
			v4[5][p] = acceptor[p][i - 2];
			v4[6][p] = nas[p][i] == 20 ? (int16_t)fs_ : (int16_t)ge_;
			Sp[p] = prof[p] + (size_t)nas[p][i] * slen_max * VL;
		}
		dim1 = x4_bcast4(v4[0]), di = x4_bcast4(v4[1]), dip1 = x4_bcast4(v4[2]);
		ai = x4_bcast4(v4[3]), aim1 = x4_bcast4(v4[4]), aim2 = x4_bcast4(v4[5]);
		gei = x4_bcast4(v4[6]);
		I = last_h = neg;
		if (i > 2) {
			H3[-1] = x4_shift_up128(x4_gather_last(H3, slen, n), neg);
			H2[-1] = x4_shift_up128(x4_gather_last(H2, slen, n), neg);
			H1[-1] = x4_shift_up128(x4_gather_last(H1, slen, n), neg);
		}
		for (j = 0; j < slen_max; ++j) {
			__mmask32 mj = (__mmask32)jmask[j];
			__m512i h, t, u, v, y, z, Sv;
			Sv = x4_load4(Sp, (size_t)j * VL, n);
			h = _mm512_adds_epi16(H3[j - 1], Sv);
			/* I */
			t = _mm512_subs_epi16(last_h, go);
			z = _mm512_maskz_set1_epi16(_mm512_cmpgt_epi16_mask(I, t), 1 << 4);
			t = _mm512_subs_epi16(_mm512_max_epi16(t, I), ge);
			I = _mm512_mask_mov_epi16(I, mj, t);
			y = _mm512_maskz_set1_epi16(_mm512_cmpgt_epi16_mask(I, h), 1);
			h = _mm512_max_epi16(h, I);
			/* D */
			u = _mm512_subs_epi16(H3[j], go), v = D3[j];
			z = _mm512_or_si512(z, _mm512_maskz_set1_epi16(
				_mm512_cmpgt_epi16_mask(v, u), 1 << 5));
			t = _mm512_subs_epi16(_mm512_max_epi16(u, v), gei);
			D[j] = t;
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 2);
			h = _mm512_max_epi16(h, t);
			/* A */
			u = _mm512_subs_epi16(H1[j], io), v = A[j];
			t = _mm512_subs_epi16(u, dim1);
			z = _mm512_or_si512(z, _mm512_maskz_set1_epi16(
				_mm512_cmpgt_epi16_mask(v, t), 1 << 6));
			t = _mm512_max_epi16(t, v);
			A[j] = t;
			t = _mm512_subs_epi16(t, ai);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 3);
			h = _mm512_max_epi16(h, t);
			/* B */
			u = _mm512_subs_epi16(H1[j - 1], io), v = B[j];
			t = _mm512_subs_epi16(u, di);
			z = _mm512_or_si512(z, _mm512_maskz_set1_epi16(
				_mm512_cmpgt_epi16_mask(v, t), 1 << 7));
			t = _mm512_max_epi16(t, v);
			B[j] = t;
			t = _mm512_subs_epi16(t, aim2);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 4);
			h = _mm512_max_epi16(h, t);
			/* C */
			v = C[j];
			t = _mm512_subs_epi16(u, dip1);
			z = _mm512_or_si512(z, _mm512_maskz_set1_epi16(
				_mm512_cmpgt_epi16_mask(v, t), 1 << 8));
			t = _mm512_max_epi16(t, v);
			C[j] = t;
			t = _mm512_subs_epi16(t, aim1);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 5);
			h = _mm512_max_epi16(h, t);
			/* frameshift transitions */
			t = _mm512_subs_epi16(H1[j], fs);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 6);
			h = _mm512_max_epi16(h, t);
			t = _mm512_subs_epi16(H2[j], fs);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 7);
			h = _mm512_max_epi16(h, t);
			t = _mm512_subs_epi16(H1[j - 1], fs);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 8);
			h = _mm512_max_epi16(h, t);
			t = _mm512_subs_epi16(H2[j - 1], fs);
			y = _mm512_mask_set1_epi16(y, _mm512_cmpgt_epi16_mask(t, h), 9);
			h = _mm512_max_epi16(h, t);
			z = _mm512_or_si512(z, y);
			_mm512_storeu_si512((void *)(tbi + (size_t)j * VLW), z);
			H[j] = h;
			last_h = _mm512_mask_mov_epi16(last_h, mj, h);
		}
		I = _mm512_max_epi16(_mm512_subs_epi16(last_h, goe),
		                     _mm512_subs_epi16(I, ge));
		{
			__mmask32 passm = live;
			for (k = 0; k < VL && passm; ++k) { /* lazy-F, 8-lane semantics */
				__mmask32 runm = passm;
				I = x4_shift_up128(I, neg);
				for (j = 0; j < slen_max && runm; ++j) {
					__mmask32 m = runm & (__mmask32)jmask[j];
					__m512i h = H[j], hn, z, hs;
					__mmask32 gtm, gt2;
					if (!m) break;  /* stripe masks shrink with j */
					hn = _mm512_max_epi16(h, I);
					gtm = _mm512_cmpgt_epi16_mask(I, h) & m;
					if (gtm) {
						z = _mm512_loadu_si512((void *)(tbi + (size_t)j * VLW));
						z = _mm512_or_si512(z, _mm512_maskz_set1_epi16(gtm, 1 << 9));
						_mm512_storeu_si512((void *)(tbi + (size_t)j * VLW), z);
					}
					H[j] = _mm512_mask_mov_epi16(h, m, hn);
					hs = _mm512_subs_epi16(hn, goe);
					I = _mm512_mask_mov_epi16(I, (__mmask32)jmask[j],
					                          _mm512_subs_epi16(I, ge));
					gt2 = _mm512_cmpgt_epi16_mask(I, hs);
					for (p = 0; p < n; ++p) {
						__mmask32 pm = (__mmask32)0xffu << (p * 8);
						if ((m & pm) && !(gt2 & pm)) {
							runm &= ~pm;  /* inner break */
							passm &= ~pm; /* exits lazy-F */
						}
					}
				}
				passm &= runm;
			}
		}
		tmpv = H3, H3 = H2, H2 = H1, H1 = H, H = tmpv;
		tmpv = D3, D3 = D2, D2 = D1, D1 = D, D = tmpv;
		for (p = 0; p < n; ++p)
			if (i == nls[p] - 1)
				out_scores[p] = ((const int16_t *)H1)[
					(size_t)((als[p] - 1) % slen[p]) * VLW + p * VL
					+ (als[p] - 1) / slen[p]];
	}

	for (p = 0; p < n; ++p)
		n_cigs[p] = dp_backtrack_st(tb + p * VL, slen[p], VLW,
		                            (int64_t)slen_max * VLW, nls[p], als[p],
		                            cig_buf + cig_off[p]);
}

#else
static int mx_have_avx512bw(void) { return 0; }
static int mx_have_avx512bw_raw(void) { return 0; }
static int32_t mx_no_x4 = 0;
#endif

MX_EXPORT void mx_dp16(
	const uint8_t *nsq, int32_t nl, const uint8_t *asq, int32_t al,
	const uint8_t *ss,
	const int8_t *mat, int32_t asize,
	const uint8_t *nt4, const uint8_t *aa20, const uint8_t *codon_tab,
	const int32_t *sp, int32_t sp_null_bonus,
	int32_t flag, int32_t go_, int32_t ge_, int32_t io_, int32_t fs_,
	int32_t xdrop, int32_t end_bonus, float ie_coef,
	int32_t *out_score, int32_t *out_nt_len, int32_t *out_aa_len,
	uint32_t *cigar, int32_t *n_cigar)
{
	const int32_t is_ext = !!(flag & (DPF_EXT_LEFT | DPF_EXT_RIGHT));
	const int32_t slen = (al + VL - 1) / VL;
	const uint8_t aa_x = aa20['X'];
	int32_t i, j, k;
	uint8_t *nas, *aas;
	int8_t *donor, *acceptor;
	int16_t *prof;   /* asize * slen vectors */
	v16 *bufH, *H, *H1, *H2, *H3, *Hmax, *D, *D1, *D2, *D3, *A, *B, *C, *tmpv;
	int16_t *tb = 0;
	v16 go = v_set1(go_), ge = v_set1(ge_), goe = v_set1(go_ + ge_), io = v_set1(io_), fs = v_set1(fs_);

	*n_cigar = 0;
	*out_nt_len = nl, *out_aa_len = al, *out_score = MX_NEG_INF;

	if (al == 0) {
		/* degenerate rectangle (reachable via block-resolution debug
		 * paths): slen would be 0 and the stripe arithmetic divides by
		 * it — the reference binary crashes here (nasw-sse.c j%slen).
		 * Emit the deterministic all-deletion tail the backtracker
		 * produces for an exhausted query, scored as one affine
		 * deletion of nl/3 aa plus a frameshift for the remainder, so
		 * callers summing dp_score never see the NEG_INF sentinel. */
		if (is_ext) { *out_nt_len = 0; *out_aa_len = 0; return; }
		if (flag & DPF_CIGAR) {
			int32_t n = 0, l = nl / 3, sc = 0;
			if (l > 0) n = push_cigar(cigar, n, C_D, l * 3), sc -= go_ + ge_ * l;
			if (nl % 3 != 0) n = push_cigar(cigar, n, C_F, nl % 3), sc -= fs_;
			for (k = 0; k < n >> 1; ++k) {
				uint32_t tmp = cigar[k];
				cigar[k] = cigar[n - 1 - k];
				cigar[n - 1 - k] = tmp;
			}
			*n_cigar = n;
			*out_score = sc;
		}
		return;
	}

	nas = (uint8_t*)mx_scratch(0, nl);
	aas = (uint8_t*)mx_scratch(1, al > 0 ? al : 1);
	donor = (int8_t*)mx_scratch(2, nl + 1);
	acceptor = (int8_t*)mx_scratch(3, nl + 1);
	if (flag & DPF_EXT_LEFT) { /* reversed input */
		for (j = 0; j < al; ++j) aas[al - 1 - j] = aa20[asq[j]];
		prep_rev(nsq, nl, nt4, sp, ss, io_, sp_null_bonus, nas, donor, acceptor);
		prep_nas(nsq, nl, nt4, codon_tab, aa_x, nas);
		for (i = 0; i < nl >> 1; ++i) { uint8_t t = nas[i]; nas[i] = nas[nl - 1 - i]; nas[nl - 1 - i] = t; }
		/* nl < 2 would make the shift length negative (size_t-huge);
		 * the reference's ns_prep_seq_left has the same unguarded
		 * memmove (nasw-sse.c:207) but is never reached with nl < 3 -
		 * our --dbg-no-refine path can be (block-resolution anchors) */
		if (nl > 2) memmove(nas + 2, nas, nl - 2);
		if (nl > 0) nas[0] = aa_x;
		if (nl > 1) nas[1] = aa_x;
	} else {
		for (j = 0; j < al; ++j) aas[j] = aa20[asq[j]];
		prep_fwd(nsq, nl, nt4, sp, ss, io_, sp_null_bonus, nas, donor, acceptor);
		prep_nas(nsq, nl, nt4, codon_tab, aa_x, nas);
	}

#if defined(__x86_64__)
	if (is_ext && al > 8 && go_ > 0 && mx_have_avx512bw()) {
		/* wide score-only path: identical outputs, 32 lanes per op.  Its
		 * exact cross-lane carry needs go > 0: at go == 0 the 8-lane
		 * lazy-F breaks at its first step (I - ge <= max(H, I) - ge), so
		 * the reference's scores depend on its 8-lane striping */
		dp16_ext_w(nas, donor, acceptor, aas, nl, al, mat, asize,
		           go_, ge_, io_, fs_, xdrop, end_bonus, ie_coef,
		           out_score, out_nt_len, out_aa_len);
		return;
	}
#endif

	/* striped query profile; nasw-sse.c:212-224: vector j lane k = position k*slen+j */
	prof = (int16_t*)mx_scratch(4, (size_t)asize * slen * VL * 2);
	{
		int16_t *t = prof;
		for (i = 0; i < asize; ++i) {
			const int8_t *ma = mat + i * asize;
			for (j = 0; j < slen; ++j)
				for (k = j; k < slen * VL; k += slen)
					*t++ = k >= al ? NEG16 : ma[aas[k]];
		}
	}

	/* state buffers: 5 x (slen+1) for H/H1/H2/H3/Hmax (index -1 valid), 7 x slen */
	bufH = (v16*)mx_scratch(5, ((size_t)(slen + 1) * 5 + (size_t)slen * 7) * 16);
	H = bufH + 1, H1 = bufH + (slen + 1) + 1, H2 = bufH + (slen + 1) * 2 + 1, H3 = bufH + (slen + 1) * 3 + 1;
	Hmax = bufH + (slen + 1) * 4 + 1;
	D = Hmax + slen, D1 = D + slen, D2 = D1 + slen, D3 = D2 + slen;
	A = D3 + slen, B = A + slen, C = B + slen;
	for (i = 0; i < (slen + 1) * 5 + slen * 7; ++i)
		bufH[i] = v_set1(NEG16);
	H3[-1][0] = 0;
	H2[-1][0] = -fs_;
	H1[-1][0] = -fs_;

	if ((flag & DPF_CIGAR) && !is_ext)
		tb = (int16_t*)mx_scratch(6, (size_t)nl * slen * VL * 2);

	if (tb == 0) { /* score-only / extension path; nasw-sse.c:349-443 */
		int32_t max_sc = MX_NEG_INF, max_sc_log = MX_NEG_INF, tmp_sc, tmp_sc_log, end_sc, max_i = -1;
		int32_t pen_len = al * 3;
		for (i = 2; i < nl; ++i) {
			v16 I, last_h, maxv, gei;
			v16 dim1 = v_set1(donor[i - 1]), di = v_set1(donor[i]), dip1 = v_set1(donor[i + 1]);
			v16 ai = v_set1(acceptor[i]), aim1 = v_set1(acceptor[i - 1]), aim2 = v_set1(acceptor[i - 2]);
			const int16_t *S = prof + (size_t)nas[i] * slen * VL;
			gei = nas[i] == 20 ? fs : ge;
			I = last_h = v_set1(NEG16);
			if (i > 2) {
				H3[-1] = v_shift_up(H3[slen - 1], NEG16);
				H2[-1] = v_shift_up(H2[slen - 1], NEG16);
				H1[-1] = v_shift_up(H1[slen - 1], NEG16);
			}
			maxv = v_set1(NEG16);
			for (j = 0; j < slen; ++j) {
				v16 h, t, u, v, Sv;
				memcpy(&Sv, S + j * VL, 16);
				h = v_sadd(H3[j - 1], Sv);
				/* I */
				t = v_ssub(last_h, go);
				t = v_max(t, I);
				I = v_ssub(t, ge);
				h = v_max(h, I);
				/* D */
				u = H3[j]; v = D3[j];
				t = v_max(v_ssub(u, go), v);
				t = v_ssub(t, gei);
				D[j] = t;
				h = v_max(h, t);
				/* A */
				u = v_ssub(H1[j], io); v = A[j];
				t = v_ssub(u, dim1);
				t = v_max(t, v);
				A[j] = t;
				h = v_max(h, v_ssub(t, ai));
				/* B */
				u = v_ssub(H1[j - 1], io); v = B[j];
				t = v_ssub(u, di);
				t = v_max(t, v);
				B[j] = t;
				h = v_max(h, v_ssub(t, aim2));
				/* C */
				v = C[j];
				t = v_ssub(u, dip1);
				t = v_max(t, v);
				C[j] = t;
				h = v_max(h, v_ssub(t, aim1));
				/* frameshift transitions */
				h = v_max(h, v_ssub(H1[j], fs));
				h = v_max(h, v_ssub(H2[j], fs));
				h = v_max(h, v_ssub(H1[j - 1], fs));
				h = v_max(h, v_ssub(H2[j - 1], fs));
				maxv = v_max(maxv, h);
				H[j] = h;
				last_h = h;
			}
			I = v_max(v_ssub(last_h, goe), v_ssub(I, ge));
			for (k = 0; k < VL; ++k) { /* lazy-F */
				I = v_shift_up(I, NEG16);
				for (j = 0; j < slen; ++j) {
					v16 h = H[j];
					h = v_max(h, I);
					maxv = v_max(maxv, h);
					H[j] = h;
					h = v_ssub(h, goe);
					I = v_ssub(I, ge);
					if (v_all_le(I, h)) break;
				}
				if (j < slen) break;
			}
			tmp_sc = v_hmax(maxv);
			end_sc = H[(al - 1) % slen][(al - 1) / slen] + end_bonus;
			tmp_sc = tmp_sc > end_sc ? tmp_sc : end_sc;
			tmp_sc_log = tmp_sc - (i - pen_len < 2 ? 0 : (int32_t)(ie_coef * mx_log2f(i - pen_len) + .5f));
			if (tmp_sc_log > max_sc_log) {
				max_sc = tmp_sc, max_sc_log = tmp_sc_log, max_i = i;
				memcpy(&Hmax[-1], &H[-1], (size_t)(slen + 1) * 16);
			}
			tmpv = H3, H3 = H2, H2 = H1, H1 = H, H = tmpv;
			tmpv = D3, D3 = D2, D2 = D1, D1 = D, D = tmpv;
			if (max_sc_log - tmp_sc_log > xdrop) break;
		}
		if (is_ext) {
			for (j = 0; j < al; ++j) {
				int32_t sc = Hmax[j % slen][j / slen];
				if (j == al - 1) sc += end_bonus;
				if (sc == max_sc) break;
			}
			*out_nt_len = max_i + 1, *out_aa_len = j + 1, *out_score = max_sc;
		}
	} else { /* traceback path; nasw-sse.c:444-541 */
		for (i = 2; i < nl; ++i) {
			int16_t *tbi = tb + (int64_t)i * slen * VL;
			v16 I, last_h, gei;
			v16 dim1 = v_set1(donor[i - 1]), di = v_set1(donor[i]), dip1 = v_set1(donor[i + 1]);
			v16 ai = v_set1(acceptor[i]), aim1 = v_set1(acceptor[i - 1]), aim2 = v_set1(acceptor[i - 2]);
			const int16_t *S = prof + (size_t)nas[i] * slen * VL;
			gei = nas[i] == 20 ? fs : ge;
			I = last_h = v_set1(NEG16);
			if (i > 2) {
				H3[-1] = v_shift_up(H3[slen - 1], NEG16);
				H2[-1] = v_shift_up(H2[slen - 1], NEG16);
				H1[-1] = v_shift_up(H1[slen - 1], NEG16);
			}
			for (j = 0; j < slen; ++j) {
				v16 h, t, u, v, y, z, Sv;
				memcpy(&Sv, S + j * VL, 16);
				y = v_set1(0);
				z = v_set1(0);
				h = v_sadd(H3[j - 1], Sv);
				/* I */
				t = v_ssub(last_h, go);
				z = v_orbit_gt(z, I, t, 1 << 4);
				t = v_max(t, I);
				I = v_ssub(t, ge);
				y = v_sel_gt(y, I, h, 1);
				h = v_max(h, I);
				/* D */
				u = v_ssub(H3[j], go); v = D3[j];
				z = v_orbit_gt(z, v, u, 1 << 5);
				t = v_max(u, v);
				t = v_ssub(t, gei);
				D[j] = t;
				y = v_sel_gt(y, t, h, 2);
				h = v_max(h, t);
				/* A */
				u = v_ssub(H1[j], io); v = A[j];
				t = v_ssub(u, dim1);
				z = v_orbit_gt(z, v, t, 1 << 6);
				t = v_max(t, v);
				A[j] = t;
				t = v_ssub(t, ai);
				y = v_sel_gt(y, t, h, 3);
				h = v_max(h, t);
				/* B */
				u = v_ssub(H1[j - 1], io); v = B[j];
				t = v_ssub(u, di);
				z = v_orbit_gt(z, v, t, 1 << 7);
				t = v_max(t, v);
				B[j] = t;
				t = v_ssub(t, aim2);
				y = v_sel_gt(y, t, h, 4);
				h = v_max(h, t);
				/* C */
				v = C[j];
				t = v_ssub(u, dip1);
				z = v_orbit_gt(z, v, t, (int16_t)(1 << 8));
				t = v_max(t, v);
				C[j] = t;
				t = v_ssub(t, aim1);
				y = v_sel_gt(y, t, h, 5);
				h = v_max(h, t);
				/* frameshift transitions */
				t = v_ssub(H1[j], fs);
				y = v_sel_gt(y, t, h, 6);
				h = v_max(h, t);
				t = v_ssub(H2[j], fs);
				y = v_sel_gt(y, t, h, 7);
				h = v_max(h, t);
				t = v_ssub(H1[j - 1], fs);
				y = v_sel_gt(y, t, h, 8);
				h = v_max(h, t);
				t = v_ssub(H2[j - 1], fs);
				y = v_sel_gt(y, t, h, 9);
				h = v_max(h, t);
				z = z | y;
				memcpy(tbi + j * VL, &z, 16);
				H[j] = h;
				last_h = h;
			}
			I = v_max(v_ssub(last_h, goe), v_ssub(I, ge));
			for (k = 0; k < VL; ++k) { /* lazy-F */
				I = v_shift_up(I, NEG16);
				for (j = 0; j < slen; ++j) {
					v16 h, z;
					memcpy(&z, tbi + j * VL, 16);
					h = H[j];
					z = v_orbit_gt(z, I, h, (int16_t)(1 << 9));
					h = v_max(h, I);
					memcpy(tbi + j * VL, &z, 16);
					H[j] = h;
					h = v_ssub(h, goe);
					I = v_ssub(I, ge);
					if (v_all_le(I, h)) break;
				}
				if (j < slen) break;
			}
			tmpv = H3, H3 = H2, H2 = H1, H1 = H, H = tmpv;
			tmpv = D3, D3 = D2, D2 = D1, D1 = D, D = tmpv;
		}
	}
	if (!is_ext) *out_score = H1[(al - 1) % slen][(al - 1) / slen];
	if (tb)
		*n_cigar = dp_backtrack(tb, slen, nl, al, cigar);
	/* all temporaries live in the grow-only scratch; nothing to free */
}

/* Batched CIGAR DP over up to 4 problems sharing one option set.
 * Pointer args come in as int64 addresses (ctypes-friendly); ss_addr
 * entries may be 0.  Problems must have al >= 1 and nl >= 3 to take the
 * batched path; otherwise (or without AVX-512BW) each problem runs
 * through mx_dp16.  Results are bit-identical either way. */
MX_EXPORT void mx_dp16x4(
	int32_t n,
	const int64_t *nsq_addr, const int32_t *nls,
	const int64_t *asq_addr, const int32_t *als,
	const int64_t *ss_addr,
	const int8_t *mat, int32_t asize,
	const uint8_t *nt4, const uint8_t *aa20, const uint8_t *codon_tab,
	const int32_t *sp, int32_t sp_null_bonus,
	int32_t go_, int32_t ge_, int32_t io_, int32_t fs_,
	int32_t *out_scores, uint32_t *cig_buf, const int64_t *cig_off, int32_t *n_cigs)
{
	int32_t p, use_x4;
	use_x4 = n > 1 && n <= 4 && mx_have_avx512bw_raw() && !mx_no_x4;
	for (p = 0; p < n && use_x4; ++p)
		if (als[p] < 1 || nls[p] < 3) use_x4 = 0;
#if defined(__x86_64__)
	if (use_x4) {
		const uint8_t *nsqs[X4], *asqs[X4], *sss[X4];
		for (p = 0; p < n; ++p) {
			nsqs[p] = (const uint8_t *)(intptr_t)nsq_addr[p];
			asqs[p] = (const uint8_t *)(intptr_t)asq_addr[p];
			sss[p] = (const uint8_t *)(intptr_t)ss_addr[p];
		}
		dp16_cig_x4(n, nsqs, nls, asqs, als, sss, mat, asize, nt4, aa20,
		            codon_tab, sp, sp_null_bonus, go_, ge_, io_, fs_,
		            out_scores, cig_buf, cig_off, n_cigs);
		return;
	}
#endif
	for (p = 0; p < n; ++p) {
		int32_t ntl, aal;
		mx_dp16((const uint8_t *)(intptr_t)nsq_addr[p], nls[p],
		        (const uint8_t *)(intptr_t)asq_addr[p], als[p],
		        (const uint8_t *)(intptr_t)ss_addr[p],
		        mat, asize, nt4, aa20, codon_tab, sp, sp_null_bonus,
		        DPF_CIGAR, go_, ge_, io_, fs_, 100, 5, 0.5f,
		        out_scores + p, &ntl, &aal, cig_buf + cig_off[p], n_cigs + p);
	}
}

/*
 * Anchor tight-block filter.  [pinned-order]  Marks (bit 31) anchors
 * sitting inside "tight blocks" — runs of >= min_cnt anchors whose
 * consecutive steps stay in frame and within max_aa_dist — after
 * trimming trim_back query-aa off both block edges, so the later DP
 * re-aligns the block boundaries freely.  The run/trim arithmetic is
 * the filter's spec (parity target mp_filter_seed, align.c:6-31);
 * the run-interval scan below is our own organization.
 */
MX_EXPORT void mx_filter_seed(int64_t cnt, uint64_t *a, int32_t max_aa_dist,
                              int32_t min_cnt, int32_t kmer2, int32_t trim_back)
{
	int64_t s = 0;
	while (s < cnt) {
		/* grow the run [s, e) while consecutive steps stay tight */
		int64_t e = s + 1, lo, hi;
		int32_t q_end, q_base;
		while (e < cnt) {
			int32_t dx = (int32_t)(a[e] >> 32) - (int32_t)(a[e - 1] >> 32);
			int32_t dy = (int32_t)a[e] - (int32_t)a[e - 1];
			if (dx % 3 != 0 || dx > max_aa_dist * 3 || dy > max_aa_dist) break;
			++e;
		}
		if (e - s < min_cnt) { ++s; continue; }
		/* trim: drop anchors within trim_back aa of either block edge */
		q_end = (int32_t)a[e - 1];
		for (hi = e - 2; hi >= s; --hi)
			if (q_end - (int32_t)a[hi] >= trim_back) break;
		q_base = (int32_t)a[s] + 1 - kmer2;
		for (lo = s; lo < hi; ++lo)
			if ((int32_t)a[lo] + 1 - q_base >= trim_back) break;
		for (; lo <= hi; ++lo)
			a[lo] |= 1ULL << 31;
		s = e;
	}
}

/*******************************************
 * Six-frame genome ORF modimer sketching  *
 *******************************************/

/* [pinned]  Invertible 32-bit integer hash masked to the k-mer width.
 * Index compatibility (identical .mpi files, identical modimer
 * selection) requires the exact mixing constants of the reference's
 * hash (sketch.c:7-16, itself the classic Jenkins 32-bit mix); any
 * other hash selects a different k-mer sample. */
static inline uint32_t mx_hash32(uint32_t key, uint32_t mask)
{
	key = (key + ~(key << 15)) & mask;
	key ^= key >> 10;
	key = (key + (key << 3)) & mask;
	key ^= key >> 6;
	key = (key + ~(key << 11)) & mask;
	key ^= key >> 16;
	return key;
}

/* One-strand three-frame ORF modimer scan (behavioural equivalent of
 * miniprot_tpu.sketch.sketch_nt4 and the reference mp_sketch_nt4 +
 * mp_sketch_clean_orf, sketch.c:40-100).  Output order is per-frame
 * sequential; every caller sorts scalar u64s afterwards, so only the
 * multiset matters for byte-parity.
 *
 *   seq      nt4 codes of one contig strand (0..3 ACGT, >=4 ambiguous)
 *   codon    codon -> aa20 table (64 entries; >=20 means stop/ambiguous)
 *   codon13  codon -> reduced 13-letter code (64 entries)
 *   out      capacity >= n + 4 (one window may end at every position);
 *            entries (hash>>mod_bit)<<32 | blockId
 *            with blockId = (endPos >> bbit) + boff
 * Returns the number of entries written, or -1 on allocation failure. */
/* Emit the modimers of one ORF run of run_len reduced codes rc[] whose
 * first codon ends at genome position run_start. */
static int64_t sketch_flush_run(const uint8_t *rc, int64_t run_len,
                                int64_t run_start, int32_t kmer,
                                uint32_t mask, uint32_t keep_mask,
                                int32_t mod_bit, int32_t bbit, int64_t boff,
                                uint64_t *out)
{
	int64_t t, cnt = 0;
	uint32_t x = 0;
	for (t = 0; t < run_len; ++t) {
		x = (x << 4 | rc[t]) & mask;
		if (t >= kmer - 1) {
			uint32_t y = mx_hash32(x, mask);
			if ((y & keep_mask) == 0)
				out[cnt++] = (uint64_t)(y >> mod_bit) << 32
					| (((uint64_t)(run_start + 3 * t) >> bbit) + boff);
		}
	}
	return cnt;
}

MX_EXPORT int64_t mx_sketch_nt4(const uint8_t *seq, int64_t n,
                                int32_t min_aa_len, int32_t kmer,
                                int32_t mod_bit, int32_t bbit, int64_t boff,
                                const uint8_t *codon, const uint8_t *codon13,
                                uint64_t *out)
{
	int64_t cnt = 0, p, run_start = 0, run_len = 0;
	int32_t f;
	const uint32_t mask = (uint32_t)((1ULL << (4 * kmer)) - 1);
	const uint32_t keep_mask = (1U << mod_bit) - 1U;
	uint8_t *rc;
	if (n < 3) return 0;
	rc = (uint8_t *)malloc(n / 3 + 2);
	if (rc == 0) return -1;
	for (f = 0; f < 3; ++f) {
		run_len = 0;
		for (p = f + 2; p < n; p += 3) {
			int sense = 0;
			uint8_t red = 0;
			if (seq[p - 2] < 4 && seq[p - 1] < 4 && seq[p] < 4) {
				int c = seq[p - 2] << 4 | seq[p - 1] << 2 | seq[p];
				if (codon[c] < 20) sense = 1, red = codon13[c];
			}
			if (sense) {
				if (run_len == 0) run_start = p;
				rc[run_len++] = red;
				continue;
			}
			if (run_len >= min_aa_len)
				cnt += sketch_flush_run(rc, run_len, run_start, kmer, mask,
				                        keep_mask, mod_bit, bbit, boff, out + cnt);
			run_len = 0;
		}
		if (run_len >= min_aa_len)
			cnt += sketch_flush_run(rc, run_len, run_start, kmer, mask,
			                        keep_mask, mod_bit, bbit, boff, out + cnt);
	}
	free(rc);
	return cnt;
}

/* Frame-0 ungapped rescoring (mp_score_ungapped semantics, align.c:33-43:
 * the loop strides 3 over alen-in-aa, scoring ceil(alen/3) codons). */
MX_EXPORT int32_t mx_score_ungapped(const uint8_t *nseq, const uint8_t *aseq,
                                    int32_t alen, const int8_t *mat,
                                    int32_t asize, const uint8_t *codon,
                                    const uint8_t *aa20)
{
	int32_t i, j, sc = 0;
	for (i = 0, j = 0; i < alen; i += 3, ++j) {
		int nt_aa = 21; /* X */
		if (nseq[i] < 4 && nseq[i + 1] < 4 && nseq[i + 2] < 4)
			nt_aa = codon[nseq[i] << 4 | nseq[i + 1] << 2 | nseq[i + 2]];
		sc += mat[nt_aa * asize + aa20[aseq[j]]];
	}
	return sc;
}

/* Batched trivial-gap rescoring: tri[] holds n (nt_off, aa_off, alen)
 * triples indexing into the shared region nt/aa arrays. */
MX_EXPORT void mx_score_ungapped_many(const uint8_t *nt, const uint8_t *aa,
                                      const int64_t *tri, int32_t n,
                                      const int8_t *mat, int32_t asize,
                                      const uint8_t *codon, const uint8_t *aa20,
                                      int32_t *out)
{
	int32_t k;
	for (k = 0; k < n; ++k)
		out[k] = mx_score_ungapped(nt + tri[3 * k], aa + tri[3 * k + 1],
		                           (int32_t)tri[3 * k + 2], mat, asize,
		                           codon, aa20);
}

/* [pinned-order]  Per-CIGAR-op alignment statistics (behavioral spec:
 * the per-codon inner loops of mp_extra_cal, align.c:82-201; the split-
 * codon base choice at U/V introns and the "stop/iden/plus" counting
 * rules are the spec).  Organization differs from the reference: this
 * emits per-op deltas out[4k..4k+3] = (d_n_stop, d_n_iden, d_n_plus,
 * d_score) for the Python caller to fold into region records, and every
 * sequence read is bounds-checked (the reference reads out of bounds on
 * block-resolution debug regions).  For each op k writes
 * out[4k..4k+3] = (d_n_stop, d_n_iden, d_n_plus, d_score):
 * M ops walk their codons against the protein, U/V ops score the split
 * codon, I/D ops charge the affine gap, F/G ops charge the frameshift
 * penalty.  nt starts at r.vs, aa at r.qs (nt4 / raw byte codes). */
MX_EXPORT void mx_extra_stats(const uint8_t *nt, const uint8_t *aa,
                              int64_t l_nt, int64_t l_aa,
                              const uint32_t *cig, int32_t n_cig,
                              const int8_t *mat, int32_t asize,
                              const uint8_t *codon, const uint8_t *aa20,
                              int32_t go, int32_t ge, int32_t fs,
                              int32_t *out)
{
	/* l_nt/l_aa bound every sequence read: a valid CIGAR never crosses
	 * them (align.c:194-200 asserts consumption), but block-resolution
	 * debug regions can - the reference reads out of bounds there */
	int64_t nl = 0, al = 0;
	int32_t k;
	for (k = 0; k < n_cig; ++k) {
		int32_t op = cig[k] & 0xF, ln = cig[k] >> 4;
		int32_t st = 0, id = 0, pl = 0, sc = 0, t;
		if (op == 0) {          /* M */
			int64_t i = nl, j = al;
			for (t = 0; t < ln; ++t, i += 3, ++j) {
				int nt_aa = 21, aa_aa = j < l_aa ? aa20[aa[j]] : 21;
				int8_t s;
				if (i + 2 < l_nt && nt[i] < 4 && nt[i+1] < 4 && nt[i+2] < 4)
					nt_aa = codon[nt[i] << 4 | nt[i+1] << 2 | nt[i+2]];
				s = mat[nt_aa * asize + aa_aa];
				st += nt_aa == 20;
				id += nt_aa == aa_aa;
				pl += s > 0;
				sc += s;
			}
			nl += 3 * (int64_t)ln, al += ln;
		} else if (op == 1) {   /* I */
			sc = -(go + ge * ln);
			al += ln;
		} else if (op == 2) {   /* D */
			int64_t i = nl;
			for (t = 0; t < ln; ++t, i += 3)
				if (i + 2 < l_nt && nt[i] < 4 && nt[i+1] < 4 && nt[i+2] < 4)
					st += codon[nt[i] << 4 | nt[i+1] << 2 | nt[i+2]] == 20;
			sc = -(go + ge * ln);
			nl += 3 * (int64_t)ln;
		} else if (op == 10) {  /* F */
			sc = -fs;
			nl += ln;
		} else if (op == 11) {  /* G */
			sc = -fs;
			nl += ln, al += 1;
		} else if (op == 3 || op == 12 || op == 13) {  /* N/U/V introns */
			if (op != 3) {      /* split codon at a phase-1/2 intron */
				int in_nt = nl + ln - 1 < l_nt && ln >= 2;
				uint8_t n0 = in_nt ? nt[nl] : 4, n1 = 4, n2 = 4;
				int nt_aa = 21, aa_aa = al < l_aa ? aa20[aa[al]] : 21;
				int8_t s;
				if (in_nt) {
					if (op == 12) n1 = nt[nl + ln - 2], n2 = nt[nl + ln - 1];
					else          n1 = nt[nl + 1],      n2 = nt[nl + ln - 1];
				}
				if (n0 < 4 && n1 < 4 && n2 < 4)
					nt_aa = codon[n0 << 4 | n1 << 2 | n2];
				s = mat[nt_aa * asize + aa_aa];
				st += nt_aa == 20;
				id += nt_aa == aa_aa;
				pl += s > 0;
				sc += s;
			}
			nl += ln;
			al += op != 3;
		}
		out[4 * k] = st, out[4 * k + 1] = id;
		out[4 * k + 2] = pl, out[4 * k + 3] = sc;
	}
}

/* [pinned-order]  cs:Z: difference string over the extended CIGAR.
 * The emitted byte grammar (:len, *ref-alt, +seq, -seq, ~don len acc)
 * and the split-codon handling at U/V introns are the output format
 * itself (spec: mp_write_cs, format.c:102-187); reads here are bounds-
 * checked and the walker is organized around a (nt,aa) cursor pair.
 * nt: nt4 codes of [r.vs, r.ve); aa: raw query
 * bytes from r.qs.  Writes into buf (caller sizes it at
 * 3*nt_len + aa_len + 24*n_cig + 16); returns the byte length, or -1
 * if the CIGAR does not consume exactly (nt_len, aa_len). */
static const char cs_nt_low[6] = "acgtn";

static inline char cs_up(uint8_t b)
{
	return (char)(b >= 'a' && b <= 'z' ? b - 32 : b);
}

static inline char cs_low_nt(uint8_t x) { return cs_nt_low[x > 4 ? 4 : x]; }

MX_EXPORT int64_t mx_write_cs(const uint8_t *nt, int64_t nt_len,
                              const uint8_t *aa, int64_t aa_len,
                              const uint32_t *cig, int32_t n_cig,
                              const uint8_t *codon, const uint8_t *aa20,
                              char *buf)
{
	int64_t nl = 0, al = 0;
	int32_t k, t;
	char *p = buf;
	for (k = 0; k < n_cig; ++k) {
		int32_t op = cig[k] & 0xF, ln = cig[k] >> 4;
		if (op == 0) {          /* M */
			int32_t run = 0;
			int64_t i = nl, j = al;
			for (t = 0; t < ln; ++t, i += 3, ++j) {
				int nt_aa = 21, aa_aa = aa20[aa[j]];
				if (nt[i] < 4 && nt[i+1] < 4 && nt[i+2] < 4)
					nt_aa = codon[nt[i] << 4 | nt[i+1] << 2 | nt[i+2]];
				if (nt_aa != aa_aa) {
					if (run > 0) p += sprintf(p, ":%d", run);
					*p++ = '*';
					*p++ = cs_low_nt(nt[i]);
					*p++ = cs_low_nt(nt[i+1]);
					*p++ = cs_low_nt(nt[i+2]);
					*p++ = cs_up(aa[j]);
					run = 0;
				} else ++run;
			}
			if (run > 0) p += sprintf(p, ":%d", run);
			nl += 3 * (int64_t)ln, al += ln;
		} else if (op == 1) {   /* I */
			*p++ = '+';
			for (t = 0; t < ln; ++t) *p++ = cs_up(aa[al + t]);
			al += ln;
		} else if (op == 2) {   /* D */
			*p++ = '-';
			for (t = 0; t < 3 * ln; ++t) *p++ = cs_low_nt(nt[nl + t]);
			nl += 3 * (int64_t)ln;
		} else if (op == 10) {  /* F */
			*p++ = '-';
			for (t = 0; t < ln; ++t) *p++ = cs_low_nt(nt[nl + t]);
			nl += ln;
		} else if (op == 11) {  /* G */
			*p++ = '*';
			for (t = 0; t < ln; ++t) *p++ = cs_low_nt(nt[nl + t]);
			*p++ = cs_up(aa[al]);
			nl += ln, al += 1;
		} else if (op == 3 || op == 12 || op == 13) {  /* N/U/V */
			int32_t lshift = op == 3 ? 0 : op == 12 ? 1 : 2;
			int32_t rshift = lshift == 0 ? 0 : 3 - lshift;
			if (lshift > 0) {
				*p++ = '*';
				for (t = 0; t < lshift; ++t) *p++ = cs_low_nt(nt[nl + t]);
				*p++ = cs_up(aa[al]);
			}
			*p++ = '~';
			*p++ = cs_low_nt(nt[nl + lshift]);
			*p++ = cs_low_nt(nt[nl + lshift + 1]);
			p += sprintf(p, "%d", ln - lshift - rshift);
			*p++ = cs_low_nt(nt[nl + ln - rshift - 2]);
			*p++ = cs_low_nt(nt[nl + ln - rshift - 1]);
			if (rshift > 0) {
				*p++ = '-';
				for (t = 0; t < rshift; ++t)
					*p++ = cs_low_nt(nt[nl + ln - rshift + t]);
			}
			if (lshift) al += 1;
			nl += ln;
		}
	}
	if (nl != nt_len || al != aa_len) return -1;
	return p - buf;
}

/* LSD radix sort of scalar u64 keys with constant-byte pass skipping.
 * For SCALAR u64 arrays the sorted output is fully determined by the
 * multiset (equal keys are indistinguishable), so this may replace the
 * reference-permutation MSD sorter wherever the values are plain u64 —
 * the permutation-sensitive case is only the 128-bit pair sort. */
MX_EXPORT int64_t mx_sort_u64_lsd(uint64_t *a, int64_t n)
{
	mx_scr_t *s = mx_scr_get();
	int64_t cnt[256], pos[256];
	int64_t i;
	int b;
	uint64_t orx = 0, andx = ~0ULL;
	uint64_t *buf, *src, *dst;
	if (n <= 1) return n;
	if (n <= MX_RS_MIN) { ins_sort_u64(a, n); return n; }
	if (!s) return -1;
	if (s->sbuf_cap < n) {
		free(s->sbuf);
		s->sbuf = (uint64_t *)malloc((n + n / 2) * sizeof(uint64_t));
		s->sbuf_cap = s->sbuf ? n + n / 2 : 0;
	}
	buf = s->sbuf;
	if (buf == 0) return -1;
	for (i = 0; i < n; ++i) orx |= a[i], andx &= a[i];
	src = a, dst = buf;
	for (b = 0; b < 8; ++b) {
		int sh = 8 * b;
		if (!(((orx ^ andx) >> sh) & 0xFF)) continue;
		memset(cnt, 0, sizeof(cnt));
		for (i = 0; i < n; ++i) ++cnt[src[i] >> sh & 0xFF];
		pos[0] = 0;
		for (i = 1; i < 256; ++i) pos[i] = pos[i - 1] + cnt[i - 1];
		for (i = 0; i < n; ++i) dst[pos[src[i] >> sh & 0xFF]++] = src[i];
		{ uint64_t *t = src; src = dst; dst = t; }
	}
	if (src != a) memcpy(a, src, n * sizeof(uint64_t));
	return n;
}

/* Refine-round seed pairs (map.c:53-79): for each hash group of the
 * sorted mixed array sd (genome entries hash<<32|pos, protein entries
 * additionally bit31-flagged, so genome sorts first within a group),
 * emit the (genome x protein) cross product as anchors
 * (gpos<<32 | qpos) when 0 < n1*n2 <= max_ava.  out == NULL counts
 * only.  Output order within the call is irrelevant: the caller
 * value-sorts the scalar u64 anchors next. */
static int64_t mx_refine_pairs(const uint64_t *sd, int64_t n,
                                  int64_t max_ava, uint64_t *out)
{
	int64_t i = 0, cnt = 0;
	while (i < n) {
		uint32_t h = sd[i] >> 32;
		int64_t j = i + 1, k, n1, n2;
		while (j < n && (uint32_t)(sd[j] >> 32) == h) ++j;
		k = i;
		while (k < j && !(sd[k] >> 31 & 1)) ++k;
		n1 = k - i, n2 = j - k;
		if (n1 > 0 && n2 > 0 && n1 * n2 <= max_ava) {
			if (out) {
				int64_t p, q;
				for (p = i; p < k; ++p)
					for (q = k; q < j; ++q)
						out[cnt++] = (sd[p] & 0xFFFFFFFFULL) << 32
							| (sd[q] & 0x7FFFFFFFULL);
			} else cnt += n1 * n2;
		}
		i = j;
	}
	return cnt;
}

/* Small-array sorters shared by the streaming bucket build: buckets
 * are tiny (mean occupancy ~12) and mostly nearly-sorted (interleaved
 * ascending frame runs), so an early-exit insertion sort below 48
 * elements plus a byte-wise LSD radix above it keeps the per-bucket
 * finalize cache-local. */
static void u32_sort_small(uint32_t *a, int64_t n)
{
	int64_t i, j;
	for (i = 1; i < n; ++i) {
		uint32_t x = a[i];
		if (x >= a[i - 1]) continue;
		for (j = i; j > 0 && x < a[j - 1]; --j) a[j] = a[j - 1];
		a[j] = x;
	}
}

static void u32_sort(uint32_t *a, int64_t n)
{
	if (n <= 48) { u32_sort_small(a, n); return; }
	{	/* byte-wise LSD with a scratch buffer; skips constant bytes */
		uint32_t *buf = (uint32_t*)mx_scratch(25, n * 4);
		uint32_t *src = a, *dst = buf, orx = 0, andx = ~0u;
		int64_t cnt[256], pos[256], i;
		int b;
		for (i = 0; i < n; ++i) orx |= a[i], andx &= a[i];
		for (b = 0; b < 4; ++b) {
			int sh = 8 * b;
			if (!(((orx ^ andx) >> sh) & 0xFF)) continue;
			memset(cnt, 0, sizeof(cnt));
			for (i = 0; i < n; ++i) ++cnt[src[i] >> sh & 0xFF];
			pos[0] = 0;
			for (i = 1; i < 256; ++i) pos[i] = pos[i - 1] + cnt[i - 1];
			for (i = 0; i < n; ++i) dst[pos[src[i] >> sh & 0xFF]++] = src[i];
			{ uint32_t *t = src; src = dst; dst = t; }
		}
		if (src != a) memcpy(a, src, n * 4);
	}
}

/* [original]  Streaming fused bucket build over RAW per-strand
 * (hash, block) parts.  Replaces the count / scan / scatter / finalize
 * pass chain, whose cost at genome scale was dominated by random access
 * into the 64MB cursor table and the full-size kb array, and by
 * first-touch faults on per-part copies.  Usage:
 *   mx_bb_reset(n_bucket);
 *   for each part: mx_bb_add(entries, n)   // straight off the sketcher
 *   w = mx_bb_finish(ki, n_bucket, kb);
 * mx_bb_add partitions the part's entries by partition id
 * (bucket >> bpp_bits) into a part-major region of one growing buffer,
 * so the part is consumed immediately (no copy is retained).
 * mx_bb_finish then works partition by partition: count /
 * exclusive-scan / scatter / per-bucket sort+dedup with the counts,
 * cursors and the kb slice all L1/L2-resident (<=65536 buckets per
 * partition).  Output is byte-identical to the reference pipeline
 * (per-strand radix sort + dedup, sketch.c:94-99, then counting
 * scatter, index.c:71-95): every bucket ends fully sorted ascending +
 * deduped, which equals the reference's part-order concatenation of
 * sorted runs because block ranges are disjoint and ascending across
 * strand parts.  The build's state is process-wide: one build at a
 * time, its calls from any one thread. */
static int64_t *mx_bb_off;      /* per-part (npart+1) partition offsets */
static uint64_t *mx_bb_buf;     /* the parts' entries, part-major */
static size_t mx_bb_buf_cap;    /* bytes */
static int64_t mx_bb_nparts, mx_bb_cap_parts, mx_bb_total;
static int mx_bb_bucket_bits, mx_bb_bpp_bits;

/* grow the entry buffer to at least size bytes, keeping its contents
 * (1.5x over-allocation, so the copies amortize to O(total)) */
static int mx_bb_grow(size_t size)
{
	uint64_t *t;
	size_t cap;
	if (mx_bb_buf_cap >= size) return 0;
	cap = size + size / 2 + 256;
	t = (uint64_t*)realloc(mx_bb_buf, cap);
	if (!t) return -1;
	mx_bb_buf = t, mx_bb_buf_cap = cap;
	return 0;
}

MX_EXPORT void mx_bb_reset(int64_t n_bucket, int64_t reserve)
{
	int bb = 0;
	while (((int64_t)1 << bb) < n_bucket) ++bb;
	mx_bb_bucket_bits = bb;
	mx_bb_bpp_bits = bb < 14 ? bb : 14;  /* 16K buckets/partition:
	    cursor tables stay L1/L2-resident, the kb slice ~L2-sized */
	mx_bb_nparts = mx_bb_total = 0;
	/* drop any state left by an aborted build: the offset rows are
	 * sized (npart+1), and npart depends on n_bucket, so reusing a
	 * buffer allocated for a different n_bucket would overflow it */
	free(mx_bb_off);
	mx_bb_off = 0, mx_bb_cap_parts = 0;
	free(mx_bb_buf);
	mx_bb_buf = 0, mx_bb_buf_cap = 0;
	/* pre-reserve the entry buffer (caller estimates from genome
	 * length): growth copies + refaults on multi-100MB reallocs are
	 * expensive on fault-slow virtualized hosts */
	if (reserve > 0) mx_bb_grow((size_t)reserve * 8);
}

MX_EXPORT int32_t mx_bb_add(const uint64_t *a, int64_t n)
{
	int64_t npart = (int64_t)1 << (mx_bb_bucket_bits - mx_bb_bpp_bits);
	const int shift = 32 + mx_bb_bpp_bits;
	int64_t *off, i, q, s;
	uint64_t *dst;
	if (mx_bb_nparts + 1 > mx_bb_cap_parts) {
		int64_t cap = mx_bb_cap_parts ? mx_bb_cap_parts * 2 : 16;
		int64_t *t = (int64_t*)realloc(mx_bb_off,
		                               (size_t)cap * (npart + 1) * 8);
		if (!t) return -1;
		mx_bb_off = t, mx_bb_cap_parts = cap;
	}
	if (mx_bb_grow((size_t)(mx_bb_total + n) * 8) < 0) return -1;
	off = mx_bb_off + mx_bb_nparts * (npart + 1);
	dst = mx_bb_buf + mx_bb_total;
	memset(off, 0, (size_t)(npart + 1) * 8);
	for (i = 0; i < n; ++i) ++off[(a[i] >> shift) + 1];
	for (q = 1; q <= npart; ++q) off[q] += off[q - 1];
	(void)s;
	/* off[q] = start of partition q, off[npart] = n */
	{
		int64_t *cur = (int64_t*)malloc((size_t)npart * 8);
		if (!cur) return -1;
		for (q = 0; q < npart; ++q) cur[q] = off[q];
		for (i = 0; i < n; ++i)
			dst[cur[a[i] >> shift]++] = a[i];
		free(cur);
	}
	mx_bb_total += n;
	++mx_bb_nparts;
	return 0;
}

MX_EXPORT int64_t mx_bb_finish(int64_t *ki, int64_t n_bucket, uint32_t *kb)
{
	int64_t npart = (int64_t)1 << (mx_bb_bucket_bits - mx_bb_bpp_bits);
	int64_t nbpp = (int64_t)1 << mx_bb_bpp_bits;
	int64_t q, w = 0, g = 0, ip;
	int64_t *lst = (int64_t*)malloc((size_t)nbpp * 2 * 8);
	int64_t *pstart;   /* per-part start offset in the entry buffer */
	const uint64_t *buf = mx_bb_buf;
	(void)n_bucket;
	pstart = (int64_t*)malloc((size_t)(mx_bb_nparts > 0 ? mx_bb_nparts : 1) * 8);
	if (!lst || !pstart) { free(lst); free(pstart); return -1; }
	for (ip = 0, g = 0; ip < mx_bb_nparts; ++ip) {
		int64_t *off = mx_bb_off + ip * (npart + 1);
		pstart[ip] = g;
		g += off[npart];
	}
	/* per partition: count / scan / scatter / sort+dedup.  Raw scatter
	 * positions reuse global raw offsets, so the compaction cursor w
	 * never catches up with unread data (w <= raw offset consumed). */
	for (q = 0, g = 0; q < npart; ++q) {
		int64_t *bst = lst, *bcur = lst + nbpp;
		int64_t base = q << mx_bb_bpp_bits, i, j, st, qraw = 0;
		memset(bst, 0, (size_t)nbpp * 8);
		for (ip = 0; ip < mx_bb_nparts; ++ip) {
			int64_t *off = mx_bb_off + ip * (npart + 1);
			const uint64_t *s0 = buf + pstart[ip] + off[q];
			int64_t m = off[q + 1] - off[q];
			for (i = 0; i < m; ++i) ++bst[(s0[i] >> 32) & (nbpp - 1)];
			qraw += m;
		}
		if (qraw == 0) {
			for (j = 0; j < nbpp; ++j) ki[base + j] = w;
			continue;
		}
		for (j = 0, st = g; j < nbpp; ++j) {
			int64_t c = bst[j];
			bst[j] = bcur[j] = st, st += c;
		}
		for (ip = 0; ip < mx_bb_nparts; ++ip) {
			int64_t *off = mx_bb_off + ip * (npart + 1);
			const uint64_t *s0 = buf + pstart[ip] + off[q];
			int64_t m = off[q + 1] - off[q];
			for (i = 0; i < m; ++i)
				kb[bcur[(s0[i] >> 32) & (nbpp - 1)]++] = (uint32_t)s0[i];
		}
		for (j = 0; j < nbpp; ++j) {
			int64_t b0 = bst[j], b1 = bcur[j];
			ki[base + j] = w;
			if (b1 <= b0) continue;
			u32_sort(kb + b0, b1 - b0);
			kb[w++] = kb[b0];
			for (i = b0 + 1; i < b1; ++i)
				if (kb[i] != kb[w - 1]) kb[w++] = kb[i];
		}
		g += qraw;
	}
	free(lst);
	free(pstart);
	free(mx_bb_off);
	mx_bb_off = 0, mx_bb_cap_parts = 0, mx_bb_nparts = 0, mx_bb_total = 0;
	free(mx_bb_buf);
	mx_bb_buf = 0, mx_bb_buf_cap = 0;
	return w;
}

/* One-pass FASTA body packer (mp_ntseq_read's inner loop, ntseq.c:29-77):
 * append the bases of body[st:en] - skipping newlines - to the 4-bit
 * packed genome stream at base offset off (low nibble first), mapping
 * characters through nt4[].  Returns the new base offset.  Replaces a
 * newline-strip copy + table gather + concatenate + strided-interleave
 * pack chain in numpy (4-5 full-size intermediates). */
MX_EXPORT int64_t mx_fa_pack(const uint8_t *body, int64_t st, int64_t en,
                             const uint8_t *nt4, uint8_t *packed, int64_t off)
{
	int64_t i, o = off;
	for (i = st; i < en; ++i) {
		uint8_t ch = body[i];
		uint8_t c;
		if (ch == '\n' || ch == '\r') continue;
		c = nt4[ch];
		if (o & 1) packed[o >> 1] |= (uint8_t)(c << 4);
		else packed[o >> 1] = c;
		++o;
	}
	return o;
}

/* Protein modimer sketch (mp_sketch_prot, sketch.c:18-38): rolling
 * 4-bit reduced-alphabet k-mer, reset at ambiguous residues (aa13 code
 * >= 14), keep windows whose hash has the low mod_bit bits zero.
 * out must have room for n entries; returns the count. */
MX_EXPORT int64_t mx_sketch_prot(const uint8_t *seq, int64_t n,
                                 const uint8_t *aa13, int32_t kmer,
                                 int32_t mod_bit, uint64_t *out)
{
	int64_t i, cnt = 0;
	int32_t l = 0;
	uint32_t x = 0;
	const uint32_t mask_k = (1u << (4 * kmer)) - 1;
	const uint32_t mask_mod = (1u << mod_bit) - 1;
	for (i = 0; i < n; ++i) {
		uint8_t c = aa13[seq[i]];
		if (c < 14) {
			x = (x << 4 | c) & mask_k;
			if (++l >= kmer) {
				uint32_t y = mx_hash32(x, mask_k);
				if ((y & mask_mod) == 0)
					out[cnt++] = (uint64_t)(y >> mod_bit) << 32 | (uint32_t)i;
			}
		} else x = 0, l = 0;
	}
	return cnt;
}

/* Unpack 4-bit-packed genome bases [s, e) into nt4 codes; optional
 * reverse-complement (mp_ntseq_get semantics, ntseq.c:89-106:
 * revcomp maps c < 4 to 3-c, ambiguous codes pass through). */
MX_EXPORT void mx_unpack(const uint8_t *packed, int64_t s, int64_t e,
                         int32_t rev, uint8_t *out)
{
	int64_t i, n = e - s;
	if (n <= 0) return;
	if (!rev) {
		for (i = 0; i < n; ++i) {
			uint8_t b = packed[(s + i) >> 1];
			out[i] = (s + i) & 1 ? b >> 4 : b & 0xF;
		}
	} else {
		for (i = 0; i < n; ++i) {
			int64_t p = e - 1 - i;
			uint8_t c = (p & 1) ? packed[p >> 1] >> 4 : packed[p >> 1] & 0xF;
			out[i] = c < 4 ? 3 - c : c;
		}
	}
}

/* ---------------------------------------------------------------- */
/* [original]  Host alignment-region driver.
 *
 * Runs the whole per-region DP-step plan of the alignment round in
 * native code: left/right score-only extensions with the cheaper
 * io_end terminal-exon retry, the left-clip CIGAR rectangle, one
 * CIGAR DP (or the trivial exact-size ungapped shortcut) per marked
 * anchor gap, and the right-tail rectangle — behavioral spec
 * mp_align, align.c:239-342.  The Python generator
 * (align.align_region_steps) implements the identical plan for the
 * device engine and serves as this driver's parity oracle
 * (tests/test_native.py).  Eliminates ~15 Python/ctypes round trips
 * and ~6 numpy slice copies per region on the host path.
 *
 * av[]: region-local anchors (nt_off<<32 | qpos), starting at the
 * first marked (bit31) anchor; only marked entries participate.
 * Genome coordinates (vs0, as_, ae and the vs/ve outputs) are int64.
 * Returns the summed dp_score, the merged CIGAR, the final region
 * rectangle, and profiler counts (DP calls + cells).
 */
MX_EXPORT void mx_align_region(
	const uint8_t *nt, int64_t l_nt, const uint8_t *ss,
	const uint8_t *aa, int32_t qlen,
	const uint64_t *av, int64_t n_av,
	int64_t vs0, int64_t as_, int64_t ae,
	int64_t in_ve, int32_t in_qe, int32_t more_dp,
	const int8_t *mat, int32_t asize,
	const uint8_t *nt4, const uint8_t *aa20, const uint8_t *codon_tab,
	const int32_t *sp, int32_t sp_null_bonus,
	int32_t go_, int32_t ge_, int32_t io_, int32_t io_end,
	int32_t fs_, int32_t xdrop, int32_t end_bonus, float ie_coef,
	int32_t kmer2, int32_t max_ext, int32_t use_x4,
	int32_t *out_score, int64_t *out_vs, int32_t *out_qs,
	int64_t *out_ve, int32_t *out_qe,
	uint32_t *cig, int32_t *n_cig,
	int64_t *out_cells, int32_t *out_ndp)
{
	int64_t vs1, r_ve, ne0, base, k;
	int32_t as1, r_qe, ae0, score = 0, nc = 0;
	int32_t sc, nt_len, aa_len, r_ntl = 0, r_aal = 0, ncig_tmp;
	int32_t do_right, n_marked = 0, n_jobs = 0, n_plan = 0;
	int64_t cells = 0;
	int32_t ndp = 0;
	uint32_t ext_cig[16];  /* ext modes never emit ops; sized like the
	                          Python wrapper's _EMPTY_CIG for safety */
	/* per-gap job tables (malloc: mx_dp16 below owns the scratch slots) */
	int64_t *jb_nts, *jb_ntl, *jb_aas, *jb_aal;   /* job rectangles */
	int32_t *jb_sc, *jb_nc;                       /* results */
	int64_t *jb_off;                              /* cigar segment offsets */
	uint32_t *jb_cig;                             /* cigar segments */
	int32_t *plan;                                /* >=0: job idx; <0: -(Mlen+1) trivial */
	int64_t cig_cap;

	*out_score = 0, *n_cig = 0, *out_cells = 0, *out_ndp = 0;
	*out_vs = vs0, *out_qs = 0, *out_ve = in_ve, *out_qe = in_qe;
	if (n_av <= 0) return;

	for (k = 0; k < n_av; ++k)
		n_marked += (int32_t)(av[k] >> 31 & 1);
	if (!more_dp && n_marked == 0) return;

	vs1 = vs0 + (int64_t)(av[0] >> 32) + 1;
	as1 = (int32_t)(av[0] & 0x7FFFFFFFu) + 1;
	if (more_dp) {
		r_ve = in_ve, r_qe = in_qe;
	} else {
		for (k = n_av - 1; k >= 0; --k)
			if (av[k] >> 31 & 1) break;
		r_ve = vs0 + (int64_t)(av[k] >> 32) + 1;
		r_qe = (int32_t)(av[k] & 0x7FFFFFFFu) + 1;
	}

	/* left extension (align.c:280-301); reversed inputs inside mx_dp16 */
	mx_dp16(nt, (int32_t)(vs1 - as_), aa, as1, ss, mat, asize, nt4, aa20,
	        codon_tab, sp, sp_null_bonus, DPF_EXT_LEFT, go_, ge_, io_, fs_,
	        xdrop, end_bonus, ie_coef, &sc, &nt_len, &aa_len, ext_cig, &ncig_tmp);
	cells += (int64_t)(vs1 - as_) * as1, ++ndp;

	do_right = r_qe < qlen && r_ve < ae;
	if (do_right) {
		mx_dp16(nt + (r_ve - as_), (int32_t)(ae - r_ve), aa + r_qe,
		        qlen - r_qe, ss ? ss + (r_ve - as_) : 0, mat, asize, nt4,
		        aa20, codon_tab, sp, sp_null_bonus, DPF_EXT_RIGHT, go_, ge_,
		        io_, fs_, xdrop, end_bonus, ie_coef, &sc, &r_ntl, &r_aal,
		        ext_cig, &ncig_tmp);
		cells += (int64_t)(ae - r_ve) * (qlen - r_qe), ++ndp;
	}

	/* io_end retries for terminal exons (align.c:290-296, 320-327) */
	if (aa_len != as1 && nt_len < max_ext && io_ > io_end) {
		int64_t as_alt = vs1 - as_ > max_ext ? vs1 - max_ext : as_;
		int32_t ntl2, aal2;
		mx_dp16(nt + (as_alt - as_), (int32_t)(vs1 - as_alt), aa, as1,
		        ss ? ss + (as_alt - as_) : 0, mat, asize, nt4, aa20,
		        codon_tab, sp, sp_null_bonus, DPF_EXT_LEFT, go_, ge_,
		        io_end, fs_, xdrop, end_bonus, ie_coef, &sc, &ntl2, &aal2,
		        ext_cig, &ncig_tmp);
		cells += (vs1 - as_alt) * (int64_t)as1, ++ndp;
		if (aal2 == as1) nt_len = ntl2, aa_len = aal2;
	}
	if (do_right && r_aal < qlen - r_qe && r_ntl < max_ext && io_ > io_end) {
		int64_t l_ext = ae - r_ve < max_ext ? ae - r_ve : max_ext;
		int32_t ntl2, aal2;
		mx_dp16(nt + (r_ve - as_), (int32_t)l_ext, aa + r_qe, qlen - r_qe,
		        ss ? ss + (r_ve - as_) : 0, mat, asize, nt4, aa20,
		        codon_tab, sp, sp_null_bonus, DPF_EXT_RIGHT, go_, ge_,
		        io_end, fs_, xdrop, end_bonus, ie_coef, &sc, &ntl2, &aal2,
		        ext_cig, &ncig_tmp);
		cells += l_ext * (int64_t)(qlen - r_qe), ++ndp;
		if (aal2 == qlen - r_qe) r_ntl = ntl2, r_aal = aal2;
	}

	*out_vs = vs1 - nt_len;
	*out_qs = as1 - aa_len;
	ne0 = *out_vs - vs0;
	ae0 = *out_qs;
	base = vs0 - as_;

	/* plan the gap-patching DPs (align.c:303-314) */
	{
		int32_t cap = n_marked + 2;
		plan = (int32_t*)malloc(sizeof(int32_t) * cap);
		jb_nts = (int64_t*)malloc(sizeof(int64_t) * cap);
		jb_ntl = (int64_t*)malloc(sizeof(int64_t) * cap);
		jb_aas = (int64_t*)malloc(sizeof(int64_t) * cap);
		jb_aal = (int64_t*)malloc(sizeof(int64_t) * cap);
	}

#define PLAN_GAP(nt_s_, nt_e_, aa_s_, aa_e_) do { \
	int64_t _ns = (nt_s_), _ne = (nt_e_); \
	int32_t _as = (aa_s_), _ae2 = (aa_e_), _al = _ae2 - _as; \
	if (_ne - _ns == (int64_t)_al * 3 && _al <= kmer2) { \
		score += mx_score_ungapped(nt + _ns, aa + _as, _al, mat, asize, \
		                           codon_tab, aa20); \
		plan[n_plan++] = -(_al + 1); \
	} else { \
		jb_nts[n_jobs] = _ns, jb_ntl[n_jobs] = _ne - _ns; \
		jb_aas[n_jobs] = _as, jb_aal[n_jobs] = _al; \
		plan[n_plan++] = n_jobs++; \
	} \
} while (0)

	if (more_dp) {  /* debug oracle: one DP over the whole region */
		PLAN_GAP(*out_vs - as_, in_ve - as_, ae0, in_qe);
	} else {
		int64_t nt_s = ne0 + base;
		for (k = 0; k < n_av; ++k) {
			int64_t ne1;
			int32_t ae1;
			if (!(av[k] >> 31 & 1)) continue;
			ne1 = (int64_t)(av[k] >> 32) + 1;
			ae1 = (int32_t)(av[k] & 0x7FFFFFFFu) + 1;
			PLAN_GAP(nt_s, ne1 + base, ae0, ae1);
			ne0 = ne1, ae0 = ae1, nt_s = ne1 + base;
		}
		*out_ve = ne0 + vs0;
		*out_qe = ae0;
	}

	/* right-tail rectangle joins the same batch (align.c:328-333) */
	if (do_right)
		PLAN_GAP(r_ve - as_, r_ve - as_ + r_ntl, r_qe, r_qe + r_aal);
#undef PLAN_GAP

	/* run the CIGAR jobs: order by genome length desc and batch up to
	 * 4 per AVX-512 call with the padding-waste gate (identical policy
	 * to the Python dp_cigars batcher; results are bit-identical to
	 * per-problem mx_dp16 either way) */
	cig_cap = 0;
	for (k = 0; k < n_jobs; ++k) cig_cap += jb_ntl[k] + jb_aal[k] + 16;
	jb_cig = (uint32_t*)malloc(sizeof(uint32_t) * (cig_cap > 0 ? cig_cap : 1));
	jb_off = (int64_t*)malloc(sizeof(int64_t) * (n_jobs + 1));
	jb_sc = (int32_t*)malloc(sizeof(int32_t) * (n_jobs + 1));
	jb_nc = (int32_t*)malloc(sizeof(int32_t) * (n_jobs + 1));
	{
		int64_t off = 0;
		for (k = 0; k < n_jobs; ++k)
			jb_off[k] = off, off += jb_ntl[k] + jb_aal[k] + 16;
	}
	if (n_jobs > 0) {
		int32_t *order = (int32_t*)malloc(sizeof(int32_t) * n_jobs);
		int32_t i, j;
		for (i = 0; i < n_jobs; ++i) order[i] = i;
		for (i = 1; i < n_jobs; ++i) {  /* insertion sort, nl desc, stable */
			int32_t t = order[i];
			for (j = i; j > 0 && jb_ntl[order[j - 1]] < jb_ntl[t]; --j)
				order[j] = order[j - 1];
			order[j] = t;
		}
		i = 0;
		while (i < n_jobs) {
			int32_t n_chunk = 0;
			if (use_x4) {
				int64_t cost = 0, mnl = 0, msl = 0;
				for (j = i; j < n_jobs && n_chunk < X4; ++j) {
					int64_t nl_i = jb_ntl[order[j]];
					int64_t sl_i = (jb_aal[order[j]] + 7) / 8;
					if (n_chunk > 0 &&
					    (n_chunk + 1) * mnl * (msl > sl_i ? msl : sl_i) * 10
					        > 13 * (cost + nl_i * sl_i))
						break;
					if (n_chunk == 0) mnl = nl_i, msl = sl_i;
					else msl = msl > sl_i ? msl : sl_i;
					cost += nl_i * sl_i;
					++n_chunk;
				}
			} else n_chunk = 1;
			{
				int64_t nsq_addr[X4], asq_addr[X4], ss_addr[X4], offs[X4];
				int32_t nls[X4], als[X4], scs[X4], ncs[X4];
				for (j = 0; j < n_chunk; ++j) {
					int32_t jj = order[i + j];
					nsq_addr[j] = (int64_t)(intptr_t)(nt + jb_nts[jj]);
					asq_addr[j] = (int64_t)(intptr_t)(aa + jb_aas[jj]);
					ss_addr[j] = ss ? (int64_t)(intptr_t)(ss + jb_nts[jj]) : 0;
					nls[j] = (int32_t)jb_ntl[jj];
					als[j] = (int32_t)jb_aal[jj];
					offs[j] = jb_off[jj];
					cells += jb_ntl[jj] * jb_aal[jj], ++ndp;
				}
				mx_dp16x4(n_chunk, nsq_addr, nls, asq_addr, als, ss_addr,
				          mat, asize, nt4, aa20, codon_tab, sp,
				          sp_null_bonus, go_, ge_, io_, fs_, scs, jb_cig,
				          offs, ncs);
				for (j = 0; j < n_chunk; ++j) {
					int32_t jj = order[i + j];
					jb_sc[jj] = scs[j], jb_nc[jj] = ncs[j];
				}
			}
			i += n_chunk;
		}
		free(order);
	}

	/* assemble the region CIGAR in plan order */
	for (k = 0; k < n_plan; ++k) {
		if (plan[k] < 0) {
			nc = push_cigar(cig, nc, C_M, (uint32_t)(-plan[k] - 1));
		} else {
			int32_t jj = plan[k], c;
			const uint32_t *seg = jb_cig + jb_off[jj];
			score += jb_sc[jj];
			for (c = 0; c < jb_nc[jj]; ++c)
				nc = push_cigar(cig, nc, seg[c] & 0xF, seg[c] >> 4);
		}
	}
	if (do_right) {
		*out_ve = r_ve + r_ntl;
		*out_qe = r_qe + r_aal;
	}

	*out_score = score, *n_cig = nc;
	*out_cells = cells, *out_ndp = ndp;
	free(plan), free(jb_nts), free(jb_ntl), free(jb_aas), free(jb_aal);
	free(jb_cig), free(jb_off), free(jb_sc), free(jb_nc);
}

/* ---------------------------------------------------------------- */
/* [original]  Second-round refinement of one region, in one call
 * (behavioral spec: mp_refine_reg, map.c:32-111): re-sketch the
 * region's genome window and the query with all kmer2-mers at base
 * resolution, build the per-hash seed cross products (<= max_ava),
 * re-chain, keep the best chain (first maximum), and rebase its
 * anchors to region-local coordinates.  Mirrors
 * mapper.refine_region's Python orchestration of the same C
 * primitives; that function is the parity oracle.
 *
 * Returns the best chain's anchor count (0 = region dies), with the
 * rebased anchors in an internal buffer exposed via *out_a_ptr —
 * valid until the next call on this thread (the mapper consumes it
 * immediately; the fork pool gives each worker its own process).
 * out_i32 = {chn_sc, qs, qe, chn_sc_ungap}; out_i64 = {vs_rel, ve_rel}
 * (window-relative; the caller adds the window start). */
MX_EXPORT int64_t mx_refine_region(
	const uint8_t *nt, int64_t l_nt,
	const uint8_t *aa, int64_t alen,
	const uint8_t *codon, const uint8_t *codon13, const uint8_t *aa13,
	int32_t kmer, int32_t min_aa_len, int64_t max_ava,
	int32_t max_dist_x, int32_t max_dist_y, int32_t bw, int32_t max_skip,
	int32_t max_iter, int32_t min_cnt, int32_t min_sc, float coef_log,
	int32_t is_spliced,
	int64_t **out_a_ptr, int32_t *out_i32, int64_t *out_i64)
{
	int64_t n_g, n_a_sk, n_sd, n_pairs, n_chain_a, k, i;
	int64_t best_i, best_off, n_best;
	uint64_t *sd, *pairs, *chn_a, *chn_u, *best;
	int64_t n_u;
	int64_t vs_rel;
	int32_t best_sc;

	*out_a_ptr = 0;
	/* sketch genome window (3 fwd frames; mod_bit=0, bbit=0) + query */
	sd = (uint64_t*)mx_scratch(27, (size_t)(l_nt + alen + 8) * 8);
	n_g = mx_sketch_nt4(nt, l_nt, min_aa_len, kmer, 0, 0, 0,
	                    codon, codon13, sd);
	if (n_g < 0) return 0;
	n_a_sk = mx_sketch_prot(aa, alen, aa13, kmer, 0, sd + n_g);
	for (k = n_g; k < n_g + n_a_sk; ++k)
		sd[k] |= 1ULL << 31;            /* protein entries flag (map.c:49) */
	n_sd = n_g + n_a_sk;
	if (n_sd == 0) return 0;
	mx_sort_u64_lsd(sd, n_sd);

	n_pairs = mx_refine_pairs(sd, n_sd, max_ava, 0);
	if (n_pairs == 0) return 0;
	pairs = (uint64_t*)malloc((size_t)n_pairs * 8);
	chn_a = (uint64_t*)malloc((size_t)n_pairs * 8);
	chn_u = (uint64_t*)malloc((size_t)n_pairs * 8);
	mx_refine_pairs(sd, n_sd, max_ava, pairs);
	mx_sort_u64_lsd(pairs, n_pairs);

	n_u = mx_chain(max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt,
	               min_sc, coef_log, is_spliced, kmer, 0 /* bbit */,
	               n_pairs, pairs, chn_a, chn_u, &n_chain_a);
	if (n_u == 0) {
		free(pairs), free(chn_a), free(chn_u);
		return 0;
	}
	/* best chain = first maximum score (map.c:89-96) */
	best_i = 0, best_sc = (int32_t)(chn_u[0] >> 32);
	for (i = 1; i < n_u; ++i) {
		int32_t sc = (int32_t)(chn_u[i] >> 32);
		if (sc > best_sc) best_sc = sc, best_i = i;
	}
	best_off = 0;
	for (i = 0; i < best_i; ++i)
		best_off += (uint32_t)chn_u[i];
	n_best = (uint32_t)chn_u[best_i];
	best = chn_a + best_off;

	out_i32[0] = best_sc;
	out_i32[1] = (int32_t)(uint32_t)best[0] - (kmer - 1);          /* qs */
	out_i32[2] = (int32_t)(uint32_t)best[n_best - 1] + 1;          /* qe */
	vs_rel = (int64_t)(best[0] >> 32) + 1 - 3 * kmer;
	out_i64[0] = vs_rel;
	out_i64[1] = (int64_t)(best[n_best - 1] >> 32) + 1;            /* ve_rel */
	/* rebase anchors so nt_off is relative to the new region start
	 * (map.c:107-108): nt_off' = nt_off - vs_rel */
	{
		uint64_t *dst = (uint64_t*)mx_scratch(27, (size_t)n_best * 8);
		for (i = 0; i < n_best; ++i)
			dst[i] = (uint64_t)((int64_t)(best[i] >> 32) - vs_rel) << 32
				| (uint32_t)best[i];
		out_i32[3] = mx_chn_sc_ungap(n_best, dst, kmer);
		*out_a_ptr = (int64_t*)dst;
	}
	free(pairs), free(chn_a), free(chn_u);
	return n_best;
}

/* ---------------------------------------------------------------- */
/* [original]  Per-query seed gather, in one call (behavioral spec:
 * mp_map's seed stage, map.c:155-177 + mp_cal_max_occ map.c:126-141):
 * protein modimer sketch, sort, dynamic per-query occurrence cap via
 * the boxplot outlier rule, and the bucket-table gather producing
 * anchors blockId<<32|qpos (unsorted across seeds beyond the sorted-
 * seed order; the caller sorts).  Mirrors mapper.seed_anchors (the
 * parity oracle).
 *
 * Returns the anchor count with the anchors in an internal buffer via
 * *out_ptr — valid until the next mx_refine_region/mx_seed_anchors
 * call on this thread. */
MX_EXPORT int64_t mx_seed_anchors(
	const uint8_t *seq, int64_t qlen, const uint8_t *aa13,
	int32_t kmer, int32_t mod_bit,
	const int64_t *ki, int64_t n_ki, const uint32_t *kb, int64_t n_kb,
	int64_t max_occ_cap,
	uint64_t **out_ptr)
{
	int64_t n_sd, i, total, max_occ = max_occ_cap, cnt_out = 0;
	uint64_t *sd, *out;
	*out_ptr = 0;
	if (qlen <= 0) return 0;
	sd = (uint64_t*)malloc((size_t)qlen * 8);
	n_sd = mx_sketch_prot(seq, qlen, aa13, kmer, mod_bit, sd);
	if (n_sd == 0) { free(sd); return 0; }
	mx_sort_u64_lsd(sd, n_sd);

	if (n_sd >= 8) {   /* boxplot cap (mp_cal_max_occ, map.c:126-141) */
		uint64_t *cnt = (uint64_t*)malloc((size_t)n_sd * 8);
		int64_t q25, q75, occ_dyn;
		for (i = 0; i < n_sd; ++i) {
			int64_t h = sd[i] >> 32;
			int64_t en = h + 1 < n_ki ? ki[h + 1] : n_kb;
			cnt[i] = (uint64_t)(en - ki[h]);
		}
		mx_sort_u64_lsd(cnt, n_sd);
		q25 = (int64_t)cnt[(int64_t)(n_sd * 0.25 + 0.499)];
		q75 = (int64_t)cnt[(int64_t)(n_sd * 0.75 + 0.499)];
		occ_dyn = (int64_t)(q75 + (q75 - q25) * 1.5 + 10.0);
		if (occ_dyn < max_occ) max_occ = occ_dyn;
		free(cnt);
	}

	total = 0;
	for (i = 0; i < n_sd; ++i) {
		int64_t h = sd[i] >> 32;
		int64_t en = h + 1 < n_ki ? ki[h + 1] : n_kb;
		int64_t c = en - ki[h];
		if (c <= max_occ) total += c;
	}
	out = (uint64_t*)mx_scratch(27, (size_t)(total > 0 ? total : 1) * 8);
	for (i = 0; i < n_sd; ++i) {
		int64_t h = sd[i] >> 32, st = ki[h], j;
		int64_t en = h + 1 < n_ki ? ki[h + 1] : n_kb;
		uint64_t qpos = (uint32_t)sd[i];
		if (en - st > max_occ) continue;
		for (j = st; j < en; ++j)
			out[cnt_out++] = (uint64_t)kb[j] << 32 | qpos;
	}
	free(sd);
	*out_ptr = out;
	return cnt_out;
}
