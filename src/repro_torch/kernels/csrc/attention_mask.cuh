// The attention kernels' masks (attention.cu, B3 and B4's rule;
// attention_bwd.cu, B9): causal order, a sliding window and a prefix, and
// the tiles of one side that hold a live pair for a tile of the other; and
// the order in which B3 and B9 launch their tiles (block_work).
//
// Query row i sits at position q_off + i (the reference's q_offset: a
// chunk of queries behind q_off earlier keys, Sq <= Sk); key j at j. Every
// function below takes query rows and adds q_off itself, so a caller passes
// row indices, and q_off = 0 is the arithmetic it was before the offset.
#pragma once

// B3's mask: key kpos is live for query row qrow (see the B3 note in
// attention.cu)
__device__ __forceinline__ bool key_live(int qrow, int kpos, int Sk, int causal,
                                         int window, int prefix, int q_off)
{
    if (kpos >= Sk) return false;
    const int qpos = qrow + q_off;
    const bool band = (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
    return band || kpos < prefix;
}

// The key tiles of width bk that hold a live pair for some row of the query
// rows [q0, q_last]: the prefix's tiles [0, n_pre), then [lo, lo + n -
// n_pre). Iteration it of a block's key loop takes tile
// it < n_pre ? it : lo + it - n_pre. The band's keys [max(0, q0 + q_off -
// window + 1), causal ? q_last + q_off + 1 : Sk) are contiguous, as
// consecutive rows' ranges overlap; with no window or prefix this is tiles
// [0, ceil(band / bk)), the causal loop bound.
struct KeyTiles { int n_pre, lo, n; };
__device__ __forceinline__ KeyTiles key_tiles(int q0, int q_last, int Sk, int causal,
                                              int window, int prefix, int bk, int q_off)
{
    const int hi = causal ? min(q_last + q_off + 1, Sk) : Sk;
    const int lo = window > 0 ? max(0, q0 + q_off - window + 1) : 0;
    const int pt = (min(max(prefix, 0), Sk) + bk - 1) / bk;
    const int end = max((hi + bk - 1) / bk, pt);
    const int lo_t = min(lo / bk, end);
    const int n_pre = min(pt, lo_t);
    return {n_pre, lo_t, n_pre + end - lo_t};
}

__device__ __forceinline__ int key_tile(const KeyTiles& kt, int it)
{
    return it < kt.n_pre ? it : kt.lo + it - kt.n_pre;
}

// whether the walk kt visits key tile `tile`
__device__ __forceinline__ bool walks(const KeyTiles& kt, int tile)
{
    return tile < kt.n_pre || (tile >= kt.lo && tile < kt.lo + kt.n - kt.n_pre);
}

// The query tiles of width bq that hold a live pair for some key of the
// key rows [k0, k_last] (the transposed walk, B9's dK / dV): [lo, hi).
// Band query rows i see key j for j <= i + q_off (causal) and i + q_off < j
// + window, so [causal ? k0 - q_off : 0, window > 0 ? k_last + window - 1 -
// q_off : Sq - 1], clipped to [0, Sq - 1]; a tile holding a prefix key is
// seen by every query. With no window or prefix this is [k0 / bq, ceil(Sq /
// bq)) under causal order at q_off = 0, the causal loop's bounds.
struct QueryTiles { int lo, hi; };
__device__ __forceinline__ QueryTiles query_tiles(int k0, int k_last, int Sq, int causal,
                                                  int window, int prefix, int bq,
                                                  int q_off)
{
    int lo = causal ? max(k0 - q_off, 0) : 0;
    int hi = window > 0 ? min(k_last + window - 1 - q_off, Sq - 1) : Sq - 1;
    if (k0 < prefix) { lo = 0; hi = Sq - 1; }
    const int t0 = lo / bq;
    return {t0, lo <= hi ? hi / bq + 1 : t0};
}

// Whether every (query, key) pair of the tile pair q0.. x k0.. (bq x bk) is
// live, so the per-element mask can be skipped: inside both sequences, on
// or below the diagonal and inside the window (a prefix only adds live
// pairs).
__device__ __forceinline__ bool tile_all_live(int q0, int k0, int bq, int bk, int Sq,
                                              int Sk, int causal, int window, int q_off)
{
    return q0 + bq <= Sq && k0 + bk <= Sk && !(causal && k0 + bk - 1 > q0 + q_off)
           && !(window > 0 && q0 + q_off + bq - 1 - k0 >= window);
}


// Launch order. B3, B9's dK / dV and dQ run one block per (tile, pair), a
// pair being a (batch, head) -- (batch, head, column split) for a kernel
// that splits its output columns. A block of a 1-D grid takes
// block_work(blockIdx.x): the pairs fall into groups of `group` neighbours
// (heads in order within a batch, so the query heads of one KV head and the
// splits of one head are neighbours); the groups run one after another, and
// inside a group the tiles run by rank, rank 0 -- the caller's heaviest tile
// -- for every pair of the group first. With one group (group >= the number
// of pairs) this is the order of the (pair, batch, rank) grid the kernels
// had before, block for block. A group keeps the tiles its blocks walk --
// the K / V of a query tile in B3 and dQ, the Q / dO of a key tile in dK /
// dV -- to the few pairs in flight, so they come from L2 and not from HBM
// once for every tile: multi-head latent attention gives every head K and V
// of its own, 1.3 MB a head at S 2 048, 671 MB over deepseek-v2's 512
// (batch, head) pairs of a prefill, against L2's 50 MB.
struct BlockWork { int b, pair, rank; };
__device__ __forceinline__ BlockWork block_work(int id, int n_t, int pairs_per_b, int B,
                                                int group)
{
    const int per = group * n_t;
    const int grp = id / per, r = id - grp * per;
    const int p0 = grp * group;
    const int gs = min(group, pairs_per_b * B - p0);
    const int p = p0 + r % gs;
    return {p / pairs_per_b, p % pairs_per_b, r / gs};
}

// Pairs a group holds: all of them (the kernels' order before groups) when
// the walked tiles of the whole call fit in ORDER_KEEP_BYTES, half of L2;
// else as many runs of `share` neighbouring pairs -- which walk the same
// tiles, `share_bytes` of them -- as fit in ORDER_GROUP_BYTES, so that the
// one or two groups in flight stay inside L2. In probes on the H100 groups
// of 4 to 16 MB read alike for B3 at deepseek-v2's prefill, and 16 MB read
// fastest for B9 at its training microbatch.
constexpr double ORDER_KEEP_BYTES = 24e6, ORDER_GROUP_BYTES = 16e6;
static inline int order_group(int pairs, int share, double share_bytes)
{
    if ((double)(pairs / share) * share_bytes <= ORDER_KEEP_BYTES) return pairs;
    const int runs = share_bytes >= ORDER_GROUP_BYTES ? 1 : (int)(ORDER_GROUP_BYTES / share_bytes);
    return runs * share < pairs ? runs * share : pairs;
}
