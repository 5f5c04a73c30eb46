"""Open canonical syncmer extraction ON DEVICE.

The search path reads bases through dna4 traits (ambiguity -> A,
src/main/taxor_search.cpp:181), so the scanner has NO N-resets — which
makes the state machine mostly position-parallel:

  - 2-bit k-mer/s-mer values on both strands come straight from the
    16-base packed STREAM WORDS: per phase (i mod 16) a static funnel
    shift of 2-3 adjacent words yields the window bits, the reverse
    strand is its bitwise complement and the forward strand its
    2-bit-field reversal — all on [R, L/16] arrays (16x less roll
    traffic than per-base sliding sums),
  - only the window-minimum tracker is genuinely sequential: the
    reference keeps a stateful minimum with hysteresis (leftmost min on
    the first window; on evicting the tracked min, recompute as the
    RIGHTMOST min; ties never displace the holder —
    src/hashing/syncmer.cpp:109-146).  That tracker is not a pure
    function of the current window, so it runs as a lax.scan over base
    positions carrying only (qmin_val u32, qmin_pos i32) per read —
    ~40 vector ops per step on [R]-wide lanes,
  - emitted canonical k-mers hash via the bit-exact device wyhash64
    (utils/u64jnp.py), then a 2-key lexicographic sort per read
    deduplicates (the reference returns a hash SET,
    syncmer.cpp:157-165) and compacts valid hashes to a prefix.

Upload per read: L/4 bytes of 2-bit packed bases (+1 length) — ~8x less
than shipping extracted hashes.

Restrictions (callers fall back to the host scanner otherwise):
s <= 15 (s-mer fits uint32), k <= 32, dna4 search semantics.
FracMinHash scaling applies on device as an exact integer threshold.
Build-time counting keeps the host dna5 path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.u64jnp import wyhash64


U32 = jnp.uint32
_UMAX32 = 0xFFFFFFFF

# reads longer than this use the host scanner; the device path covers
# each power-of-two length bucket up to here
L_CAP = 32768
BASES_PER_WORD = 16


def supports(scheme) -> bool:
    """Whether the device extractor covers this hash scheme."""
    return (
        scheme.use_syncmer
        and scheme.scaling >= 1
        and 2 <= scheme.syncmer_size <= 15
        and scheme.syncmer_size < scheme.kmer_size <= 32
    )


def pad_len_bucket(max_len: int) -> int:
    """Power-of-two length bucket (>= 256) to bound recompilation."""
    return max(256, 1 << (int(max_len) - 1).bit_length())


def hash_cap(L: int) -> int:
    """Static per-read hash capacity for length bucket L.  Open-syncmer
    density is ~2/(k-s+1) (< 1/4 for every valid even-k/even-s config);
    reads denser than this (adversarial) are detected via the device
    hash count and fall back to the host oracle."""
    return max(128, L // 4)


def pack_reads(seqs: list[bytes], L: int):
    """2-bit pack a read batch, 4 bases per byte.

    Returns (packed uint8 [R, L/4] with base i at bits 2*(i%4) of byte
    i//4, lengths int32 [R]).  Bases ship 2-bit packed to keep the
    upload small; the numpy fallback is branch-free u8 arithmetic +
    strided ORs.  dna4 semantics: A/a->0 C/c->1 G/g->2 T/t/U/u->3,
    everything else (incl. N) -> A, via y=(c>>1)&3 then y^(y>>1) with a
    whitelist mask (matches encode_dna4)."""
    R = len(seqs)
    lengths = np.fromiter((min(len(s), L) for s in seqs), dtype=np.int64,
                          count=R)
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        packed = np.zeros((R, L // 4), dtype=np.uint8)
        ptrs = (ctypes.c_char_p * R)(*seqs)
        lib.pack_reads_2bit(
            ptrs, lengths.ctypes.data_as(ctypes.c_void_p), R, L,
            packed.ctypes.data_as(ctypes.c_void_p),
        )
        return packed, lengths.astype(np.int32)
    # numpy fallback (no compiler): branch-free u8 arithmetic
    buf = np.zeros((R, L), dtype=np.uint8)
    for r, s in enumerate(seqs):
        n = int(lengths[r])
        buf[r, :n] = np.frombuffer(s, dtype=np.uint8, count=n)
    upper = buf & np.uint8(0xDF)  # fold lowercase
    valid = (
        (upper == 65) | (upper == 67) | (upper == 71)
        | (upper == 84) | (upper == 85)
    )
    y = (buf >> np.uint8(1)) & np.uint8(3)
    code = (y ^ (y >> np.uint8(1))) & (valid * np.uint8(3))
    packed = (
        code[:, 0::4]
        | (code[:, 1::4] << np.uint8(2))
        | (code[:, 2::4] << np.uint8(4))
        | (code[:, 3::4] << np.uint8(6))
    )
    return packed, lengths.astype(np.int32)


def _rev2_32(v):
    """Reverse the 2-bit fields of a uint32 (4 masked swap levels)."""
    v = (v >> U32(16)) | (v << U32(16))
    v = ((v & U32(0xFF00FF00)) >> U32(8)) | ((v & U32(0x00FF00FF)) << U32(8))
    v = ((v & U32(0xF0F0F0F0)) >> U32(4)) | ((v & U32(0x0F0F0F0F)) << U32(4))
    v = ((v & U32(0xCCCCCCCC)) >> U32(2)) | ((v & U32(0x33333333)) << U32(2))
    return v


def _stream_words(packed):
    """uint8 [R, L/4] (pack_reads) -> little-endian uint32 stream words
    [R, L/16]: base i sits at bits 2*(i%16) of word i//16."""
    R, W = packed.shape
    p = packed.astype(jnp.uint32).reshape(R, W // 4, 4)
    sh = (8 * jnp.arange(4, dtype=jnp.uint32))[None, None, :]
    return (p << sh).sum(axis=2).astype(jnp.uint32)


def _rolling_packed_words(packed, m: int):
    """(fhi, flo, rhi, rlo) of the m-mer ending at each base position
    (junk for i < m-1), extracted straight from 16-base STREAM WORDS.

    For each of the 16 phases c = i % 16 the window is a static funnel
    shift of 2-3 adjacent words — all shifts/rolls run on [R, L/16]
    arrays, 16x less traffic than rolling [R, L] code matrices.  The
    stream packs the OLDEST base at the low bits of the window value X,
    which IS the reference's reverse-strand orientation complemented:
    rev = ~X (2-bit complement == bitwise NOT), and the forward strand
    is the 2-bit-field reversal of X (syncmer.cpp:97-104 semantics).
    """
    Wrd = _stream_words(packed)  # [R, nw]
    R, nw = Wrd.shape
    L = nw * 16
    mask_lo = U32(0xFFFFFFFF) if m >= 16 else U32((1 << (2 * m)) - 1)
    mask_hi = U32(0) if m <= 16 else U32((1 << (2 * m - 32)) - 1)
    outs = [[None] * 16 for _ in range(4)]
    rolled = {}

    def wshift(d):
        if d not in rolled:
            rolled[d] = jnp.roll(Wrd, -d, axis=1) if d else Wrd
        return rolled[d]

    for c in range(16):
        off = 2 * c - 2 * m + 2
        jb = off >> 5          # arithmetic floor
        sh = off - 32 * jb     # 0..31
        w0, w1, w2 = wshift(jb), wshift(jb + 1), wshift(jb + 2)
        if sh == 0:
            lo, hi = w0, w1
        else:
            lo = (w0 >> U32(sh)) | (w1 << U32(32 - sh))
            hi = (w1 >> U32(sh)) | (w2 << U32(32 - sh))
        lo = lo & mask_lo if m < 16 else lo
        hi = hi & mask_hi
        rlo = (~lo) & mask_lo
        rhi = (~hi) & mask_hi
        fr_lo = _rev2_32(hi)
        fr_hi = _rev2_32(lo)
        s64 = 64 - 2 * m
        if s64 == 0:
            flo, fhi = fr_lo, fr_hi
        elif s64 < 32:
            flo = (fr_lo >> U32(s64)) | (fr_hi << U32(32 - s64))
            fhi = fr_hi >> U32(s64)
        else:
            flo = fr_hi >> U32(s64 - 32) if s64 > 32 else fr_hi
            fhi = jnp.zeros_like(fr_hi)
        outs[0][c], outs[1][c], outs[2][c], outs[3][c] = fhi, flo, rhi, rlo
    return tuple(
        jnp.stack(outs[t], axis=2).reshape(R, L) for t in range(4))


def _rolling_smers(packed, s: int):
    """Canonical s-mer value ending at each base position (junk for
    i < s-1); s <= 15 so values fit the low words."""
    _, flo, _, rlo = _rolling_packed_words(packed, s)
    return jnp.minimum(flo, rlo)


def _rolling_kmers(packed, k: int):
    """Canonical k-mer (hi, lo) uint32 pairs ending at each base
    position (junk for i < k-1).  k <= 32 -> 2k bits across the pair."""
    fhi, flo, rhi, rlo = _rolling_packed_words(packed, k)
    f_less = (fhi < rhi) | ((fhi == rhi) & (flo < rlo))
    chi = jnp.where(f_less, fhi, rhi)
    clo = jnp.where(f_less, flo, rlo)
    return chi, clo


# scan steps unrolled per lax.scan iteration: the min tracker does ~40
# vector ops on [R]-wide lanes per base, so per-iteration overhead (HBM
# dynamic slice + loop bookkeeping) dominates an un-chunked scan
_SCAN_CHUNK = 16


def _sliding_rightmost_min(ys, w: int):
    """(rm_val, rm_end) per END position i: value and end-index of the
    RIGHTMOST minimum of ys[:, i-w+1 .. i] (ties keep the larger index,
    matching syncmer.cpp:128-136's right-to-left strict-< scan).  Junk
    for i < w-1.  Van Herk/Gil-Werman: per-block prefix/suffix argmin
    scans, window = combine(suffix[i-w+1], prefix[i]); all ops VPU-wide.
    """
    R, L = ys.shape
    nb = (L + w - 1) // w
    Lp = nb * w
    ysp = ys if Lp == L else jnp.pad(
        ys, ((0, 0), (0, Lp - L)), constant_values=np.uint32(_UMAX32))
    blocks = ysp.reshape(R, nb, w)
    base = jnp.broadcast_to(
        (w * jnp.arange(nb, dtype=jnp.int32))[None, :], (R, nb))
    # prefix: rightmost argmin of block[.., :j+1] -> take on <= (a tie
    # moves right)
    pv, pe = blocks[:, :, 0], base
    pvs, pes = [pv], [pe]
    for j in range(1, w):
        bj = blocks[:, :, j]
        take = bj <= pv
        pv = jnp.where(take, bj, pv)
        pe = jnp.where(take, base + j, pe)
        pvs.append(pv)
        pes.append(pe)
    prefix_val = jnp.stack(pvs, 2).reshape(R, Lp)
    prefix_end = jnp.stack(pes, 2).reshape(R, Lp)
    # suffix: rightmost argmin of block[.., j:] -> take on strict < (the
    # incumbent right element keeps ties)
    sv, se = blocks[:, :, w - 1], base + (w - 1)
    svs, ses = [sv], [se]
    for j in range(w - 2, -1, -1):
        bj = blocks[:, :, j]
        take = bj < sv
        sv = jnp.where(take, bj, sv)
        se = jnp.where(take, base + j, se)
        svs.append(sv)
        ses.append(se)
    suffix_val = jnp.stack(svs[::-1], 2).reshape(R, Lp)
    suffix_end = jnp.stack(ses[::-1], 2).reshape(R, Lp)
    # window [a, i], a = i-w+1: suffix covers [a, block_end(a)], prefix
    # covers [block_start(i), i]; prefix indices are the larger ones, so
    # prefix wins ties (<=)
    zpad = ((0, 0), (w - 1, 0))
    suf_v = jnp.pad(suffix_val, zpad,
                    constant_values=np.uint32(_UMAX32))[:, :Lp]
    suf_e = jnp.pad(suffix_end, zpad)[:, :Lp]
    take_p = prefix_val <= suf_v
    rm_val = jnp.where(take_p, prefix_val, suf_v)
    rm_end = jnp.where(take_p, prefix_end, suf_e)
    return rm_val[:, :L], rm_end[:, :L]


@functools.partial(jax.jit, static_argnames=("k", "s", "t"))
def syncmer_kmers(packed_reads, lengths, k: int, s: int, t: int):
    """Emission mask + canonical k-mer value for every base position.

    Returns (khi, klo uint32 [R, L], emit bool [R, L]) where emit[r, i]
    marks an open-syncmer k-mer ending at base i.  Bit-equal to the host
    scanner (hash/syncmer.py) under dna4 codes — hashes are NOT applied
    here so callers can dedup on raw k-mers first (cheaper: the wyhash
    runs on the compacted [R, hcap] slice, not all L positions)."""
    w = k - s + 1
    R = packed_reads.shape[0]
    L = packed_reads.shape[1] * 4
    ys = _rolling_smers(packed_reads, s)  # [R, L] canonical smers
    khi, klo = _rolling_kmers(packed_reads, k)

    # Sliding rightmost-min of every window, PRECOMPUTED in parallel
    # (van Herk/Gil-Werman) — the only part of the reference tracker
    # that is not a pure function of the current window is WHEN the
    # recomputation applies, so the sequential scan below shrinks to the
    # ~10-op carry update while the w-element min scans run VPU-wide.
    rm_val, rm_end = _sliding_rightmost_min(ys, w)

    CH = _SCAN_CHUNK
    # pad columns so the last chunk's dynamic_slice never clamps
    # (clamping would shift the columns seen by the real trailing
    # positions); padded columns are only touched by overrun steps whose
    # emits are discarded.  Reads stay the minor (lane) axis — no
    # [R, L] transposes.
    pad_cols = jnp.full((R, CH), _UMAX32, dtype=jnp.uint32)
    ys_p = jnp.concatenate([ys, pad_cols], axis=1)  # [R, L+CH]
    rm_val_p = jnp.concatenate([rm_val, pad_cols], axis=1)
    rm_end_p = jnp.concatenate(
        [rm_end, jnp.zeros((R, CH), dtype=jnp.int32)], axis=1
    )

    # first full window: k-mer ends at i0 = k-1; ordered s-mers end at
    # s-1 .. k-1.  Leftmost minimum, strict < (syncmer.cpp:120-126).
    lmv = jnp.full((R,), _UMAX32, dtype=jnp.uint32)
    lmj = jnp.zeros((R,), dtype=jnp.int32)
    for j in range(w):
        col = ys[:, s - 1 + j]
        take = col < lmv
        lmv = jnp.where(take, col, lmv)
        lmj = jnp.where(take, jnp.int32(j), lmj)
    qmin_val0 = lmv
    qmin_pos0 = lmj  # absolute smer start = (k-1)-k+1+j = j
    emit0 = qmin_pos0 == jnp.int32(t - 1)  # i0-k+t = t-1

    def chunk_step(carry, i0):
        # one HBM slice per chunk; the CH inner steps use static slices
        blky = jax.lax.dynamic_slice(ys_p, (0, i0), (R, CH))
        blkv = jax.lax.dynamic_slice(rm_val_p, (0, i0), (R, CH))
        blke = jax.lax.dynamic_slice(rm_end_p, (0, i0), (R, CH))
        emits = []
        qmin_val, qmin_pos = carry
        for c in range(CH):
            i = i0 + c
            # the evicted smer held the min -> rightmost window min
            # (syncmer.cpp:128-136, precomputed)
            popped = qmin_pos == (i - k)
            newer = (~popped) & (blky[:, c] < qmin_val)
            qmin_val = jnp.where(popped, blkv[:, c],
                                 jnp.where(newer, blky[:, c], qmin_val))
            qmin_pos = jnp.where(
                popped, blke[:, c] - jnp.int32(s - 1),
                jnp.where(newer, i - s + 1, qmin_pos))
            emits.append(qmin_pos == (i - k + t))
        return (qmin_val, qmin_pos), jnp.stack(emits, axis=1)  # [R, CH]

    n_steps = max(0, L - k)
    if n_steps:
        nb = (n_steps + CH - 1) // CH
        # overrun steps read padded columns (garbage) — their emits are
        # sliced away below and they only run after all real positions,
        # so the carry they corrupt is never used
        starts = k + CH * jnp.arange(nb, dtype=jnp.int32)
        (_, _), emits = jax.lax.scan(
            chunk_step, (qmin_val0, qmin_pos0), starts
        )  # [nb, R, CH]
        emits = jnp.moveaxis(emits, 0, 1).reshape(R, nb * CH)[:, :n_steps]
        emit = jnp.concatenate([emit0[:, None], emits], axis=1)
    else:
        emit = emit0[:, None]
    # align: emit[:, j] corresponds to k-mer ending at base k-1+j
    pad = jnp.zeros((R, k - 1), dtype=bool)
    emit = jnp.concatenate([pad, emit], axis=1)[:, :L]
    # gate by read length (bases beyond the read are A-padding)
    emit = emit & (jnp.arange(L, dtype=jnp.int32)[None, :]
                   < lengths[:, None])
    return khi, klo, emit


@functools.partial(jax.jit, static_argnames=("k", "s", "t"))
def syncmer_emit(packed_reads, lengths, k: int, s: int, t: int):
    """syncmer_kmers + wyhash64 per position: (h_hi, h_lo, emit)."""
    khi, klo, emit = syncmer_kmers(packed_reads, lengths, k, s, t)
    h_hi, h_lo = wyhash64(khi, klo)
    return h_hi, h_lo, emit


def emission_min_gap(k: int, s: int, t: int) -> int:
    """Guaranteed minimum distance between consecutive open-syncmer
    emissions, any input.

    The tracker's holder position only moves right: a 'newer' event sets
    it to the window's right edge (offset w), a pop re-selects within the
    advanced window.  An emission at position i pins the holder at
    absolute s-mer start i-k+t, so the next emission — whose holder must
    sit t-1 from the NEW window start — needs the holder to advance:
    via a pop (the pinned holder exits after >= t more steps) or via a
    newer event (right edge reaches offset t only after w-t+1 steps).
    Hence gap >= min(t, w-t+1) for 2 <= t <= w-1; the degenerate offsets
    t==1 (pop chains) and t==w (newer chains) can emit every position."""
    w = k - s + 1
    if t < 2 or t > w - 1:
        return 1
    return min(t, w - t + 1)


_COMPACT_BLOCK = 16


def _block_compact(khi, klo, emit, min_gap: int):
    """Exact lossless pre-sort compaction: with emissions >= min_gap
    apart, a B-position block holds at most floor((B-1)/gap)+1 of them,
    so each block's emitted k-mers collapse into E static slots (selects
    on [R, L/B] tiles — no scatter).  Returns (chi, clo) of width
    (L/B)*E with all-ones sentinels in unused slots, or None when the
    gap buys nothing."""
    B = _COMPACT_BLOCK
    E = (B - 1) // max(1, min_gap) + 1
    R, L = khi.shape
    if min_gap < 2 or L % B or E * 2 > B:
        return None
    nb = L // B
    vhi = khi.reshape(R, nb, B)
    vlo = klo.reshape(R, nb, B)
    m = emit.reshape(R, nb, B)
    sent = jnp.uint32(_UMAX32)
    out_hi = [jnp.full((R, nb), sent) for _ in range(E)]
    out_lo = [jnp.full((R, nb), sent) for _ in range(E)]
    cnt = jnp.zeros((R, nb), dtype=jnp.int32)
    for j in range(B):
        mj = m[:, :, j]
        for e in range(E):
            take = mj & (cnt == e)
            out_hi[e] = jnp.where(take, vhi[:, :, j], out_hi[e])
            out_lo[e] = jnp.where(take, vlo[:, :, j], out_lo[e])
        cnt = cnt + mj.astype(jnp.int32)
    chi = jnp.stack(out_hi, axis=2).reshape(R, nb * E)
    clo = jnp.stack(out_lo, axis=2).reshape(R, nb * E)
    # defensive: a block exceeding E emissions would drop k-mers
    # silently (impossible per the gap theorem; routes the read to the
    # host-oracle fallback if it ever happens)
    overflow = (cnt > E).any(axis=1)
    return chi, clo, overflow


@functools.partial(jax.jit, static_argnames=("hcap", "min_gap"))
def dedup_kmers(khi, klo, emit, hcap: int, min_gap: int = 1):
    """Sort each read's emitted CANONICAL K-MERS, mask duplicates, slice
    to [R, hcap].  Returns (khi, klo, valid, n_unique, n_emit).

    Dedup runs on raw k-mer values, before hashing: (1) the all-ones
    sentinel is collision-free — a canonical k-mer can never be 2^64-1
    (that would need fwd == rev == all-T, but rev(all-T) == all-A), so
    unlike hash-space dedup there is no sentinel divergence; (2) the
    wyhash then only runs on the hcap-wide slice.  Unlike dedup_sorted
    there is NO compaction sort: duplicates stay interleaved with a
    False valid bit — the probe masks them.  The
    reference dedups on hash values (syncmer.cpp:160); k-mer dedup
    differs only if two distinct k-mers wyhash-collide (~2^-64/pair).

    n_emit is the pre-dedup emission count: n_emit > hcap means unique
    k-mers may sit beyond the slice, so callers must fall back to the
    host oracle for that read (n_unique alone can miss truncation —
    duplicates can push uniques past hcap).

    min_gap (emission_min_gap(k, s, t)) enables the exact block
    compaction, shrinking the sorted width ~min(min_gap, 4)x — the sort
    is the dominant cost of this step."""
    # force the extraction outputs to materialize: without the barrier
    # XLA fuses the producers into the compaction's many selects and
    # recomputes them per consumer (~3 ms/pass on the bench shape)
    khi, klo, emit = jax.lax.optimization_barrier((khi, klo, emit))
    n_emit = emit.sum(axis=1, dtype=jnp.int32)
    sent = jnp.uint32(_UMAX32)
    compacted = _block_compact(khi, klo, emit, min_gap)
    if compacted is not None:
        shi, slo, overflow = compacted
        n_emit = jnp.where(overflow, jnp.int32(2**30), n_emit)
    else:
        shi = jnp.where(emit, khi, sent)
        slo = jnp.where(emit, klo, sent)
    shi, slo = jax.lax.sort((shi, slo), dimension=1, num_keys=2)
    prev_hi = jnp.concatenate([~shi[:, :1], shi[:, :-1]], axis=1)
    prev_lo = jnp.concatenate([~slo[:, :1], slo[:, :-1]], axis=1)
    is_sent = (shi == sent) & (slo == sent)
    uniq = ((shi != prev_hi) | (slo != prev_lo)) & ~is_sent
    n_unique = uniq.sum(axis=1, dtype=jnp.int32)
    if shi.shape[1] < hcap:  # strong compaction: pad back to the
        # contract width (the gap theorem caps n_emit at the compacted
        # width, so the padding is never populated)
        pad = ((0, 0), (0, hcap - shi.shape[1]))
        shi = jnp.pad(shi, pad, constant_values=np.uint32(_UMAX32))
        slo = jnp.pad(slo, pad, constant_values=np.uint32(_UMAX32))
        uniq = jnp.pad(uniq, pad, constant_values=False)
    return (shi[:, :hcap], slo[:, :hcap], uniq[:, :hcap],
            n_unique, n_emit)


@functools.partial(jax.jit, static_argnames=("hcap",))
def dedup_sorted(h_hi, h_lo, emit, hcap: int):
    """Sort each read's emitted hashes, mask duplicates, compact to a
    [R, hcap] prefix.  Returns (hi, lo, valid, n_unique)."""
    sent = jnp.uint32(_UMAX32)
    shi = jnp.where(emit, h_hi, sent)
    slo = jnp.where(emit, h_lo, sent)
    shi, slo = jax.lax.sort((shi, slo), dimension=1, num_keys=2)
    prev_hi = jnp.concatenate([~shi[:, :1], shi[:, :-1]], axis=1)
    prev_lo = jnp.concatenate([~slo[:, :1], slo[:, :-1]], axis=1)
    is_sent = (shi == sent) & (slo == sent)
    uniq = ((shi != prev_hi) | (slo != prev_lo)) & ~is_sent
    # sentinel collision guard: a real hash equal to UMAX64 is dropped by
    # the mask above; the reference cannot distinguish it either (it
    # would hash-collide with the empty sentinel probability ~2^-64) —
    # accepted divergence, documented in DIVERGENCES.md.
    n_unique = uniq.sum(axis=1, dtype=jnp.int32)
    # duplicates sit between uniques after the sort; compact uniques to a
    # prefix with a stable sort on the inverted mask
    key = (~uniq).astype(jnp.uint8)
    _, chi, clo = jax.lax.sort((key, shi, slo), dimension=1, num_keys=1,
                               is_stable=True)
    out_hi = chi[:, :hcap]
    out_lo = clo[:, :hcap]
    valid = (jnp.arange(hcap, dtype=jnp.int32)[None, :]
             < jnp.minimum(n_unique, hcap)[:, None])
    return out_hi, out_lo, valid, n_unique


# --------------------------------------------------------------------- #
# minimizer / plain-k-mer extraction ON DEVICE
# --------------------------------------------------------------------- #
# The reference's non-syncmer scheme is seqan3 views::minimiser_hash
# (src/main/taxor_search.cpp:210-212): canonical value = min(fwd, rc) of
# the XOR-seeded 2-bit packing, windows of w' = window-k+1 values, and —
# unlike the syncmer tracker — the emission holder is ALWAYS the
# LEFTMOST sliding-window argmin (a strictly-smaller newcomer is the
# unique minimum; ties keep the older = more-left holder; slide-out
# recomputes leftmost).  That makes emission a pure per-position
# function: emit[i] <=> first full window or L(i) != L(i-1), where L is
# the leftmost argmin — no sequential scan at all.  Values emit as a
# VECTOR (duplicates kept, taxor_search.cpp:242-259), so there is no
# dedup/sort either; w' == 1 (the reference default window == k) emits
# every position: the plain canonical k-mer path.


def supports_minimizer(scheme) -> bool:
    """Whether the device minimizer/k-mer extractor covers this scheme."""
    return (
        not scheme.use_syncmer
        and scheme.scaling >= 1
        and 2 <= scheme.kmer_size <= 32
        and scheme.window_size >= scheme.kmer_size
    )


def _sliding_leftmost_min_pair(vhi, vlo, w: int):
    """(min_hi, min_lo, argmin_end) per END position i over the window
    of pair values ending at [i-w+1 .. i]: LEFTMOST minimum (ties keep
    the smaller index), lexicographic (hi, lo) u32-pair order.  Junk for
    i < w-1.  Van Herk/Gil-Werman like _sliding_rightmost_min."""
    R, L = vhi.shape
    nb = (L + w - 1) // w
    Lp = nb * w
    if Lp != L:
        pad = ((0, 0), (0, Lp - L))
        vhi = jnp.pad(vhi, pad, constant_values=np.uint32(_UMAX32))
        vlo = jnp.pad(vlo, pad, constant_values=np.uint32(_UMAX32))
    bh = vhi.reshape(R, nb, w)
    bl_ = vlo.reshape(R, nb, w)
    base = jnp.broadcast_to(
        (w * jnp.arange(nb, dtype=jnp.int32))[None, :], (R, nb))

    def less(ah, al, bh_, bl2):
        return (ah < bh_) | ((ah == bh_) & (al < bl2))

    # prefix: leftmost argmin of block[.., :j+1] -> take on strict <
    ph, plv, pe = bh[:, :, 0], bl_[:, :, 0], base
    phs, pls, pes = [ph], [plv], [pe]
    for j in range(1, w):
        jh, jl = bh[:, :, j], bl_[:, :, j]
        take = less(jh, jl, ph, plv)
        ph = jnp.where(take, jh, ph)
        plv = jnp.where(take, jl, plv)
        pe = jnp.where(take, base + j, pe)
        phs.append(ph)
        pls.append(plv)
        pes.append(pe)
    prefix_hi = jnp.stack(phs, 2).reshape(R, Lp)
    prefix_lo = jnp.stack(pls, 2).reshape(R, Lp)
    prefix_end = jnp.stack(pes, 2).reshape(R, Lp)
    # suffix: leftmost argmin of block[.., j:] -> moving left, take on <=
    sh, sl, se = bh[:, :, w - 1], bl_[:, :, w - 1], base + (w - 1)
    shs, sls, ses = [sh], [sl], [se]
    for j in range(w - 2, -1, -1):
        jh, jl = bh[:, :, j], bl_[:, :, j]
        keep = less(sh, sl, jh, jl)  # strictly smaller keeps the right
        sh = jnp.where(keep, sh, jh)
        sl = jnp.where(keep, sl, jl)
        se = jnp.where(keep, se, base + j)
        shs.append(sh)
        sls.append(sl)
        ses.append(se)
    suffix_hi = jnp.stack(shs[::-1], 2).reshape(R, Lp)
    suffix_lo = jnp.stack(sls[::-1], 2).reshape(R, Lp)
    suffix_end = jnp.stack(ses[::-1], 2).reshape(R, Lp)
    # window [a, i], a = i-w+1: suffix covers [a, block_end(a)] (the
    # LEFT part), prefix covers [block_start(i), i]; left wins ties
    zpad = ((0, 0), (w - 1, 0))
    suf_h = jnp.pad(suffix_hi, zpad,
                    constant_values=np.uint32(_UMAX32))[:, :Lp]
    suf_l = jnp.pad(suffix_lo, zpad,
                    constant_values=np.uint32(_UMAX32))[:, :Lp]
    suf_e = jnp.pad(suffix_end, zpad)[:, :Lp]
    take_p = less(prefix_hi, prefix_lo, suf_h, suf_l)
    mh = jnp.where(take_p, prefix_hi, suf_h)
    ml = jnp.where(take_p, prefix_lo, suf_l)
    me = jnp.where(take_p, prefix_end, suf_e)
    return mh[:, :L], ml[:, :L], me[:, :L]


@functools.partial(jax.jit, static_argnames=("k", "window"))
def minimizer_kmers(packed_reads, lengths, k: int, window: int):
    """Minimiser (or plain k-mer when window == k) emissions per END
    position: (vhi, vlo uint32 [R, L] emitted hash values, emit bool
    [R, L], n_emit int32 [R]).  Values are the XOR-seeded canonical
    packings the reference probes with directly (no wyhash);
    duplicates are KEPT (vector semantics)."""
    from .minimizer import adjust_seed

    wprime = window - k + 1
    R = packed_reads.shape[0]
    L = packed_reads.shape[1] * 4
    fhi, flo, rhi, rlo = _rolling_packed_words(packed_reads, k)
    seed = adjust_seed(k)
    shi = jnp.uint32(seed >> 32)
    slo = jnp.uint32(seed & 0xFFFFFFFF)
    fhi, flo = fhi ^ shi, flo ^ slo
    rhi, rlo = rhi ^ shi, rlo ^ slo
    f_less = (fhi < rhi) | ((fhi == rhi) & (flo < rlo))
    vhi = jnp.where(f_less, fhi, rhi)
    vlo = jnp.where(f_less, flo, rlo)

    iota = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid_val = (iota >= k - 1) & (iota < lengths[:, None])
    if wprime == 1:
        emit = valid_val
        n_emit = emit.sum(axis=1, dtype=jnp.int32)
        return vhi, vlo, emit, n_emit
    # mask junk before the window minima (never selected at valid i,
    # but keeps the padded tail inert)
    mvhi = jnp.where(valid_val, vhi, jnp.uint32(_UMAX32))
    mvlo = jnp.where(valid_val, vlo, jnp.uint32(_UMAX32))
    mh, ml, me = _sliding_leftmost_min_pair(mvhi, mvlo, wprime)
    first = k + wprime - 2  # end position of the first full window
    prev_me = jnp.concatenate(
        [jnp.full((R, 1), -1, jnp.int32), me[:, :-1]], axis=1)
    emit = (iota == first) | ((iota > first) & (me != prev_me))
    emit = emit & (iota < lengths[:, None])
    n_emit = emit.sum(axis=1, dtype=jnp.int32)
    return mh, ml, emit, n_emit
