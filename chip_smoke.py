#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the dedup data plane on one card.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.  It
builds the kernels (``nvcc`` for sm_90a into ``build/torch_kernels/``), then
runs one phase per line:

1. build      kernel build seconds and the card; ptxas's registers, shared
              memory and spills of both kernels; the opcodes per round of
              K2's compression loop from its SASS
2. k1         candidate-mask kernel == its plain version (small shapes and
              span edges, and the main path's [32, 64 MiB] batch segment by
              segment)
3. k2         SHA-256 kernel == its plain version and hashlib (size list),
              and == hashlib for every chunk of the full step
   k2_edges   SHA-256 kernel == hashlib (and == plain up to 4096 bytes) at
              the edges of its padding, ring and warps: every length at
              every start mod 16, ragged batches, one 16 MiB chunk among
              1,000 small ones
4. k3         device probe == the host mirror's lookup, 1 M probes against
              an index preloaded with 1 M fingerprints
5. main       DedupPipeline.process_streams over 8 x 256 MiB streams at the
              production chunking (4 MiB average), twice: backup #1, then
              backup #2 after 4 writes of 4 KiB per stream
6. streaming  CudaChunker + the "cuda" batch hasher through DeviceFeeder,
              8 writer threads feeding 4 MiB pieces
   layers     one step's time by layer, and the device's busy share under
              torch.profiler
7. timings    each kernel's time, bound, plain and library times

then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and last ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero; without a CUDA device it exits non-zero and
prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the run's size: module constants so that a rehearsal on the CPU can shrink
# them; DEVICE is the card
DEVICE = "cuda"
N_STREAMS = 8
STREAM_BYTES = 256 << 20
SHARED_BYTES = 64 << 20          # a quarter of each stream, shared by a pair
PIECE_BYTES = 4 << 20            # streaming feed size
PRELOAD = 1 << 20                # fingerprints in the index before the step
CONFIG = None                    # None: DedupConfig() (production defaults)
WRITES = 4                       # backup #2: writes of WRITE_BYTES per stream
WRITE_BYTES = 4 << 10
SHA_SIZES = [0, 1, 54, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 4096,
             65_537]
SHA_EDGE_LENS = [0, 1, 55, 56, 63, 64, 65, 119, 120, 121, 128, 4096, 65_537,
                 (1 << 20) + 3, 16 << 20]
SHA_EDGE_LONG = 16 << 20  # the one long chunk among 1,000 short ones
SHA_EDGE_BATCHES = [1, 31, 32, 33, 1000, 5000]
PLAIN_MAX_LEN = 4096      # the plain SHA-256 runs one step per block: short only

# H100 SXM data sheet: HBM3 at 3.35 TB/s; 132 SMs with 64 int32 lanes each,
# at the card's max SM clock (read from nvidia-smi)
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
# K1, counted from its SASS: INT32-pipe instructions per position; rolling:
# 2 PRMT (byte of a word), SHF (rotl 1), 2 LOP3 (xor3, mask ^ magic), ISETP;
# the closed form's 64 lookups (PRMT, SHF, half a LOP3 each) over a run of
# 132.  The table addresses are IMADs on the FMA pipe, beside them.
K1_POSITIONS_PER_THREAD = 132
K1_OPS_PER_BYTE = 6 + 64 * 2.5 / K1_POSITIONS_PER_THREAD
K1_LOOKUPS_PER_POSITION = 2 + 64 / K1_POSITIONS_PER_THREAD
# K2, counted from its SASS: INT32-pipe instructions per 64-byte block, 708
# in the compression (6 SHF, 4 LOP3, 1 IADD3 a round) and ~523 in the
# producer's load, realign, schedule and K add; its IMADs go to the FMA pipe
K2_OPS_PER_BLOCK = 708 + 523
# K2's floor per round on the longest chunk's lane, the larger of
# (a) the chain: SHF -> LOP3 -> IADD3 (e' from e), 3 dependent instructions
#     at 4 cycles each, and
# (b) dispatch: a round needs at least 10 shift and logic instructions (3 SHF
#     and a LOP3 for each of S0 and S1, a LOP3 each for ch and maj), which
#     only the INT32 pipe takes, at 2 cycles per warp instruction (16 lanes
#     per sub-partition); its 4 adds fit the FMA pipe beside them
K2_ROUND_CHAIN_CYCLES = 3 * 4
K2_ROUND_DISPATCH_CYCLES = 10 * 2
K2_ROUND_FLOOR_CYCLES = max(K2_ROUND_CHAIN_CYCLES, K2_ROUND_DISPATCH_CYCLES)


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the card, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def make_streams(seed: int) -> dict[str, np.ndarray]:
    """8 streams of 256 MiB: unique bytes around a 64 MiB region shared
    with the pair's other stream."""
    rng = np.random.default_rng(seed)
    shared = [np.frombuffer(rng.bytes(SHARED_BYTES), np.uint8)
              for _ in range(N_STREAMS // 2)]
    side = (STREAM_BYTES - SHARED_BYTES) // 2
    return {f"agent-{i:02d}": np.concatenate([
        np.frombuffer(rng.bytes(side), np.uint8), shared[i // 2],
        np.frombuffer(rng.bytes(side), np.uint8)]) for i in range(N_STREAMS)}


def rewrite(streams: dict[str, np.ndarray], seed: int) -> dict[str, np.ndarray]:
    """The same streams after WRITES writes of WRITE_BYTES each."""
    rng = np.random.default_rng(seed + 1)
    out = {}
    for name in sorted(streams):
        a = streams[name].copy()
        for off in rng.integers(0, len(a) - WRITE_BYTES, WRITES):
            a[off:off + WRITE_BYTES] = np.frombuffer(rng.bytes(WRITE_BYTES),
                                                     np.uint8)
        out[name] = a
    return out


def hashlib_digests(streams, bounds_by) -> dict[str, list[bytes]]:
    with ThreadPoolExecutor(8) as pool:
        return {n: list(pool.map(
            lambda se, a=streams[n]: hashlib.sha256(a[se[0]:se[1]]).digest(),
            bounds_by[n])) for n in sorted(streams)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 2

    from pbs_plus_tpu_torch.chunker.spec import (DEFAULT_PARAMS, TEST_PARAMS,
                                                 WINDOW, select_cuts)
    from pbs_plus_tpu_torch.models import (CudaChunker, DedupConfig,
                                           DedupPipeline, get_feeder,
                                           make_batch_hasher)
    from pbs_plus_tpu_torch.ops import _build, cuckoo, rolling_hash, sass, sha256
    from pbs_plus_tpu_torch.utils.device import host_tensor

    dev = torch.device(DEVICE)
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    int32_ops_per_s = SMS * INT32_LANES * clock_hz

    # 1. build -------------------------------------------------------------
    build_s = _build.build()
    sass_text = sass.sass_text(_build.library_path("sha256"))
    k2_sass = "not available"
    if sass_text is not None:
        body = sass.compression_loop(sass_text)
        check(body is not None, "K2's compression loop is in its SASS")
        # the schedule's plain shifts (>> 3, >> 10) and the block loads are
        # the producers' work: none of them in the compression loop
        check(not body.get("SHF.R.U32.HI") and not any(
            op.startswith("LDG") for op in body),
            f"K2's compression loop computes the schedule: {dict(body)}")
        k2_sass = sass.per_round(body)
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {n: _build.ptxas_report(n) for n in _build.SOURCES},
          "sass": {"sha256_compression_loop": k2_sass}})

    cfg = CONFIG or DedupConfig()
    P = cfg.params
    check(CONFIG is not None or P == DEFAULT_PARAMS,
          "DedupConfig default is the production params")
    t0 = time.perf_counter()
    streams = make_streams(args.seed)
    names = sorted(streams)
    gen_s = time.perf_counter() - t0

    # 2. K1 against its plain version ---------------------------------------
    rng = np.random.default_rng(args.seed + 7)
    small_max_err = 0
    for params in (TEST_PARAMS, P):
        tables_c = rolling_hash.device_tables(params, "cpu")
        tables_d = tables_c.to(dev)
        span = rolling_hash.SPAN
        for S in (1, 40, 62, 63, 64, span - 1, span, span + 1,
                  3 * span + 17, 16 * span, 17 * span + 5, 1_000_003):
            for with_hist in (False, True):
                data = torch.from_numpy(rng.integers(0, 256, (3, S), dtype=np.uint8))
                hist = torch.from_numpy(rng.integers(0, 256, (3, WINDOW - 1),
                                                     dtype=np.uint8)) \
                    if with_hist else None
                got = rolling_hash.candidate_mask(
                    data.to(dev), tables_d, params.mask, params.magic,
                    history=hist.to(dev) if with_hist else None)
                want = rolling_hash.candidate_mask_plain(
                    data.to(dev), tables_d, params.mask, params.magic,
                    hist.to(dev) if with_hist else None)
                small_max_err = max(small_max_err, int(
                    (got.to(torch.int16) - want.to(torch.int16)).abs().max()))
    check(small_max_err == 0, "K1 kernel != plain on small shapes")

    # the main path's batch: every 64 MiB segment of every stream, one row
    seg = cfg.segment_bytes
    tasks = [(n, off) for n in names for off in range(0, STREAM_BYTES, seg)]
    check(STREAM_BYTES % seg == 0 and len(tasks) <= 32,
          "the step is one candidate batch of whole segments")
    tables = rolling_hash.device_tables(P, dev)

    def device_batch(strs):
        dbuf = torch.empty((len(tasks), seg), dtype=torch.uint8, device=dev)
        dhist = torch.zeros((len(tasks), WINDOW - 1), dtype=torch.uint8,
                            device=dev)
        for i, (n, off) in enumerate(tasks):
            dbuf[i].copy_(host_tensor(strs[n][off:off + seg]))
            if off:
                dhist[i].copy_(host_tensor(strs[n][off - WINDOW + 1:off]))
        return dbuf, dhist

    def plain_cuts(strs, compare_kernel=False):
        """Cuts from the plain mask on the card + select_cuts; with
        ``compare_kernel``, holds K1's mask of the whole batch against it
        row by row."""
        dbuf, dhist = device_batch(strs)
        kernel_mask = rolling_hash.candidate_mask(
            dbuf, tables, P.mask, P.magic, history=dhist) \
            if compare_kernel else None
        ends = {n: [] for n in names}
        err, ms = 0, 0.0
        for i, (n, off) in enumerate(tasks):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = rolling_hash.candidate_mask_plain(
                dbuf[i:i + 1], tables, P.mask, P.magic, dhist[i:i + 1])
            b.record()
            b.synchronize()
            ms += a.elapsed_time(b)
            if kernel_mask is not None:
                err = max(err, int((kernel_mask[i] != want[0]).sum()))
            hits = torch.nonzero(want[0]).flatten().cpu().numpy()
            ends[n].append(hits[hits + off >= WINDOW - 1] + 1 + off)
        cuts = {n: select_cuts(np.sort(np.concatenate(ends[n])),
                               STREAM_BYTES, P) for n in names}
        bounds = {n: list(zip([0] + cuts[n][:-1], cuts[n])) for n in names}
        return bounds, err, ms, dbuf, dhist

    ref_bounds, k1_err, k1_plain_ms, dbuf, dhist = plain_cuts(
        streams, compare_kernel=True)
    check(k1_err == 0, f"K1 kernel != plain on the full batch ({k1_err} bytes)")
    emit({"phase": "k1", "small_max_abs_err": small_max_err,
          "full_batch": [len(tasks), seg], "full_mismatches": k1_err,
          "plain_ms_full_batch": k1_plain_ms, "stream_gen_s": gen_s})

    # 3. K2 against its plain version and hashlib ---------------------------
    off, sbounds = 5, []                 # unaligned starts
    for n in SHA_SIZES:
        sbounds.append((off, off + n))
        off += n
    sstream = torch.from_numpy(rng.integers(0, 256, off + 7, dtype=np.uint8)).to(dev)
    s_starts = torch.tensor([s for s, _ in sbounds], device=dev)
    s_lens = torch.tensor([e - s for s, e in sbounds], device=dev)
    k2_words = sha256.sha256_words(sstream, s_starts, s_lens)
    t_plain = time.perf_counter()
    plain_words = sha256.sha256_words_plain(sstream, s_starts, s_lens)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t_plain) * 1e3
    k2_err = int((k2_words - plain_words).abs().max())
    host = sstream.cpu().numpy()
    want = [hashlib.sha256(host[s:e]).digest() for s, e in sbounds]
    check(k2_err == 0, "K2 kernel != plain")
    check([w.astype(">u4").tobytes() for w in
           k2_words.cpu().numpy().astype(np.uint32)] == want,
          "K2 kernel != hashlib on the size list")
    k2_small_ms = cuda_ms(lambda: sha256.sha256_words(sstream, s_starts, s_lens), 5)

    ref_digests = hashlib_digests(streams, ref_bounds)
    dstream = dbuf.view(-1)     # rows are whole segments, in stream order
    step_bounds = []
    for k, n in enumerate(names):
        step_bounds += [(k * STREAM_BYTES + s, k * STREAM_BYTES + e)
                        for s, e in ref_bounds[n]]
    st_starts = torch.tensor([s for s, _ in step_bounds], device=dev)
    st_lens = torch.tensor([e - s for s, e in step_bounds], device=dev)
    step_words = sha256.sha256_words(dstream, st_starts, st_lens)
    step_digests = [w.astype(">u4").tobytes()
                    for w in step_words.cpu().numpy().astype(np.uint32)]
    check(step_digests == [d for n in names for d in ref_digests[n]],
          "K2 kernel != hashlib over the full step")
    emit({"phase": "k2", "max_abs_err": k2_err, "sizes": SHA_SIZES,
          "step_chunks": len(step_bounds), "step_digests_equal_hashlib": True})

    # K2 at the edges of its padding (55/56, 119/120 bytes), of its ring and
    # producers (blocks 1 to 4 and far beyond), of its warps (31/32/33
    # chunks) and of its longest-first order (one long chunk among short)
    edge_stream = torch.from_numpy(rng.integers(
        0, 256, max(SHA_EDGE_LENS) + SHA_EDGE_LONG + (2 << 20),
        dtype=np.uint8)).to(dev)
    edge_host = edge_stream.cpu().numpy()
    cases = {"lengths x starts mod 16": [(r, r + n) for n in SHA_EDGE_LENS
                                         for r in range(16)]}
    for nb in SHA_EDGE_BATCHES:
        ls = rng.integers(0, 3000, nb)
        cases[f"batch {nb}"] = [(int(s), int(s + n)) for s, n in
                                zip(rng.integers(0, 1 << 20, nb), ls)]
    mix = [(int(s), int(s + n)) for s, n in zip(
        rng.integers(0, 1 << 20, 1000), rng.integers(0, 5000, 1000))]
    mix.insert(517, (7, 7 + SHA_EDGE_LONG))
    cases["long among 1000"] = mix
    edge_plain_chunks = 0
    for what, bounds in cases.items():
        e_starts = torch.tensor([a for a, _ in bounds], device=dev)
        e_lens = torch.tensor([b - a for a, b in bounds], device=dev)
        got = sha256.sha256_words(edge_stream, e_starts, e_lens)
        with ThreadPoolExecutor(8) as pool:
            want = list(pool.map(lambda se: hashlib.sha256(
                edge_host[se[0]:se[1]]).digest(), bounds))
        check([w.astype(">u4").tobytes() for w in
               got.cpu().numpy().astype(np.uint32)] == want,
              f"K2 kernel != hashlib at the edges: {what}")
        short = (e_lens <= PLAIN_MAX_LEN).nonzero().flatten()
        if len(short):
            plain = sha256.sha256_words_plain(edge_stream, e_starts[short],
                                              e_lens[short])
            check(torch.equal(plain, got[short]),
                  f"K2 kernel != plain at the edges: {what}")
            edge_plain_chunks += len(short)
    emit({"phase": "k2_edges", "cases": {k: len(v) for k, v in cases.items()},
          "lengths": SHA_EDGE_LENS, "equal_hashlib": True,
          "equal_plain_chunks": edge_plain_chunks})
    del edge_stream, edge_host

    # 4. K3 against the host mirror ----------------------------------------
    t0 = time.perf_counter()
    pre = np.frombuffer(rng.bytes(32 * PRELOAD), np.uint8).reshape(-1, 32)
    preload = [bytes(r) for r in pre]
    index = cuckoo.CuckooIndex(n_buckets=cfg.index_buckets, seed=args.seed,
                               device=dev)
    index.insert_many(preload)
    preload_s = time.perf_counter() - t0
    check(index.n_buckets == cfg.index_buckets, "the preload fits the table")
    probes = np.concatenate([pre[::2], np.frombuffer(
        rng.bytes(32 * (PRELOAD // 2)), np.uint8).reshape(-1, 32)])
    got = index.probe(probes).cpu().numpy()
    check(np.array_equal(got, cuckoo.lookup_host(index._table, probes)),
          "K3 device probe != host lookup")
    check(got[:PRELOAD // 2].all(), "every preloaded digest is found")
    emit({"phase": "k3", "preloaded": PRELOAD, "probes": len(probes),
          "present_found": int(got[:PRELOAD // 2].sum()),
          "absent_maybe": int(got[PRELOAD // 2:].sum()), "preload_s": preload_s})

    # 5. the main path -------------------------------------------------------
    pipe = DedupPipeline(cfg, index=index, device=dev)
    t0 = time.perf_counter()
    fp = pipe.fingerprint_streams(streams)
    torch.cuda.synchronize()
    fp_s = time.perf_counter() - t0
    check(all(fp[n] == (ref_bounds[n], ref_digests[n]) for n in names),
          "fingerprint_streams != plain cuts + hashlib")
    rolling_hash.KERNEL.launches = 0
    sha256.KERNEL.launches = 0
    cuckoo.stats["device_probes"] = 0
    t0 = time.perf_counter()
    res = pipe.process_streams(streams)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    main_launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                     "sha256_chunks": sha256.KERNEL.launches,
                     "cuckoo_probe": cuckoo.stats["device_probes"]}
    check(all(v > 0 for v in main_launches.values()),
          f"a kernel of the main path did not launch: {main_launches}")
    known = set(preload)
    expect_new = {}
    for n in names:
        expect_new[n] = []
        for d in ref_digests[n]:
            expect_new[n].append(d not in known)
            known.add(d)
    for n in names:
        recs = res[n].chunks
        check([(c.offset, c.offset + c.length) for c in recs] == ref_bounds[n],
              f"backup #1 cuts of {n} != plain mask + select_cuts")
        check([c.digest for c in recs] == ref_digests[n],
              f"backup #1 digests of {n} != hashlib")
        check([c.is_new for c in recs] == expect_new[n],
              f"backup #1 new-chunk flags of {n} != host computation")
    chunks1 = sum(len(res[n].chunks) for n in names)
    new1 = sum(sum(expect_new[n]) for n in names)
    check(new1 < chunks1, "the shared regions dedup across streams")
    gib = N_STREAMS * STREAM_BYTES / 2**20
    emit({"phase": "main", "streams": N_STREAMS, "stream_bytes": STREAM_BYTES,
          "chunks": chunks1, "new_chunks": new1,
          "max_chunk": max(e - s for s, e in step_bounds),
          "launches": main_launches,
          "chunk_fp_s": fp_s, "chunk_fp_probe_s": step_s,
          "chunk_fp_mib_s": gib / fp_s, "chunk_fp_probe_mib_s": gib / step_s})

    streams2 = rewrite(streams, args.seed)
    ref2_bounds, *_ = plain_cuts(streams2)
    ref2_digests = hashlib_digests(streams2, ref2_bounds)
    res2 = pipe.process_streams(streams2)
    torch.cuda.synchronize()
    unchanged = new2 = 0
    for n in names:
        recs = res2[n].chunks
        check([(c.offset, c.offset + c.length) for c in recs] == ref2_bounds[n],
              f"backup #2 cuts of {n} != plain mask + select_cuts")
        check([c.digest for c in recs] == ref2_digests[n],
              f"backup #2 digests of {n} != hashlib")
        exp = []
        for c in recs:
            if c.digest in known:
                check(not c.is_new, f"backup #2 missed an unchanged chunk of {n}")
                unchanged += 1
            exp.append(c.digest not in known)
            known.add(c.digest)
        check([c.is_new for c in recs] == exp,
              f"backup #2 new-chunk set of {n} != host computation")
        new2 += sum(exp)
    check(new2 > 0, "backup #2 stores the written chunks")
    emit({"phase": "main_backup2", "chunks": sum(len(res2[n].chunks) for n in names),
          "unchanged_present": unchanged, "new_chunks": new2})
    del streams2, res2

    # 6. the streaming path --------------------------------------------------
    rolling_hash.KERNEL.launches = 0
    sha256.KERNEL.launches = 0
    hasher = make_batch_hasher("cuda", device=dev)
    out, errs = {}, []
    barrier = threading.Barrier(N_STREAMS)

    def writer(name):
        try:
            a = streams[name]
            ch = CudaChunker(P, device=dev)
            barrier.wait()
            cuts, digs, start = [], [], 0
            for off in range(0, len(a), PIECE_BYTES):
                new = ch.feed(a[off:off + PIECE_BYTES].tobytes())
                if off + PIECE_BYTES >= len(a):
                    new += ch.finalize()
                if new:
                    bounds = list(zip([start] + new[:-1], new))
                    digs += hasher([a[s:e].tobytes() for s, e in bounds])
                    cuts += new
                    start = new[-1]
            out[name] = (cuts, digs)
        except BaseException as e:     # surfaced by the check below
            errs.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=writer, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    stream_s = time.perf_counter() - t0
    check(not errs and not any(t.is_alive() for t in threads),
          f"streaming writers failed: {errs}")
    for n in names:
        check(out[n][0] == [e for _, e in ref_bounds[n]],
              f"streaming cuts of {n} != main path")
        check(out[n][1] == ref_digests[n], f"streaming digests of {n} != main path")
    fstats = dict(get_feeder(dev).stats)
    stream_launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                       "sha256_chunks": sha256.KERNEL.launches}
    check(all(v > 0 for v in stream_launches.values()),
          f"a kernel of the streaming path did not launch: {stream_launches}")
    check(fstats["max_mask_batch"] > 1, "the feeder coalesced writers")
    emit({"phase": "streaming", "writers": N_STREAMS, "piece": PIECE_BYTES,
          "seconds": stream_s, "mib_s": gib / stream_s,
          "launches": stream_launches, "feeder": fstats})

    # where one step's time goes: each layer alone, host clock around
    # synchronised calls, then the device's busy share under the profiler
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    def upload():
        buf = torch.empty(N_STREAMS * STREAM_BYTES, dtype=torch.uint8, device=dev)
        for k, n in enumerate(names):
            buf[k * STREAM_BYTES:(k + 1) * STREAM_BYTES].copy_(host_tensor(streams[n]))
        return buf

    lstream, h2d_s = timed(upload)
    base = {n: k * STREAM_BYTES for k, n in enumerate(names)}
    segs = [lstream[base[n] + off:base[n] + off + seg] for n, off in tasks]
    hists = [lstream[base[n] + off - WINDOW + 1:base[n] + off] if off else None
             for n, off in tasks]
    hit_rows, mask_s = timed(lambda: rolling_hash.batched_candidate_hits(
        segs, hists, tables, P))

    def cuts_from_hits():
        ends = {n: [] for n in names}
        for (n, off), h in zip(tasks, hit_rows):
            ends[n].append(h[h + off >= WINDOW - 1] + 1 + off)
        return {n: select_cuts(np.sort(np.concatenate(ends[n])), STREAM_BYTES, P)
                for n in names}

    _, cuts_s = timed(cuts_from_hits)
    _, sha_s = timed(lambda: sha256.sha256_stream_chunks(lstream, step_bounds))
    del lstream, segs, hists
    all_digests = [d for n in names for d in ref_digests[n]]
    _, probe_s = timed(lambda: index.probe_confirmed(all_digests))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = timed(lambda: pipe.fingerprint_streams(streams))
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.key] = dev_us.get(e.key, 0.0) + getattr(
                e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us.values()) / 1e3
    emit({"phase": "layers", "h2d_s": h2d_s, "mask_s": mask_s, "cuts_s": cuts_s, "sha_s": sha_s,
          "probe_s": probe_s, "profiled_chunk_fp_s": prof_s,
          "device_busy_ms": busy_ms if dev_us else None,
          "device_busy_share": busy_ms / (prof_s * 1e3) if dev_us else None,
          "top_device_ms": {k: v / 1e3 for k, v in sorted(
              dev_us.items(), key=lambda kv: -kv[1])[:8]}})

    # 7. timings at the main path's shapes ----------------------------------
    dbuf = dstream.view(len(tasks), seg)
    k1_ms = cuda_ms(lambda: rolling_hash.candidate_mask(
        dbuf, tables, P.mask, P.magic, history=dhist), 5)
    n_bytes = dbuf.numel()
    k1_bound_bytes = (2 * n_bytes + dhist.numel()) / HBM_BYTES_PER_S * 1e3
    k1_bound_ops = K1_OPS_PER_BYTE * n_bytes / int32_ops_per_s * 1e3
    k1_bound = max(k1_bound_bytes, k1_bound_ops)

    k2_ms = cuda_ms(lambda: sha256.sha256_words(dstream, st_starts, st_lens), 3)
    lens_np = st_lens.cpu().numpy()
    blocks = (lens_np + 8) // 64 + 1
    k2_bound_bytes = (int(lens_np.sum()) + 32 * len(lens_np)) \
        / HBM_BYTES_PER_S * 1e3
    k2_bound_ops = K2_OPS_PER_BLOCK * int(blocks.sum()) / int32_ops_per_s * 1e3
    k2_rounds = int(blocks.max()) * 64          # on the longest chunk's lane
    k2_bound_floor = k2_rounds * K2_ROUND_FLOOR_CYCLES / clock_hz * 1e3
    k2_bound = max(k2_bound_bytes, k2_bound_ops, k2_bound_floor)
    k2_cycles_per_round = k2_ms * 1e-3 * clock_hz / k2_rounds

    step_digs = np.frombuffer(b"".join(step_digests), np.uint8).reshape(-1, 32)
    table64 = index.device_table()
    ddigs = torch.from_numpy(step_digs.copy()).to(dev)
    k3_ms = cuda_ms(lambda: cuckoo._lookup(table64, ddigs), 10)
    n_d = len(step_digs)
    k3_bound = (n_d * (32 + 2 * cuckoo.BUCKET_BYTES + 1)) / HBM_BYTES_PER_S * 1e3
    k3_1m_ms = cuda_ms(lambda: index.probe(probes), 3)
    emit({"phase": "timings", "card": card, "clock_max_sm_hz": clock_hz,
          "k1": {"ms": k1_ms, "bound_bytes_ms": k1_bound_bytes,
                 "bound_ops_ms": k1_bound_ops,
                 "positions_per_thread": K1_POSITIONS_PER_THREAD,
                 "lookups_per_position": K1_LOOKUPS_PER_POSITION,
                 "int32_ops_per_position": K1_OPS_PER_BYTE,
                 "span": rolling_hash.SPAN,
                 "grid_x_spans": rolling_hash.span_partition(seg)},
          "k2": {"ms": k2_ms, "cycles_per_round": k2_cycles_per_round,
                 "instructions_per_round": k2_sass["instructions_per_round"]
                 if isinstance(k2_sass, dict) else "not available",
                 "bound_bytes_ms": k2_bound_bytes,
                 "bound_ops_ms": k2_bound_ops, "bound_floor_ms": k2_bound_floor,
                 "floor_cycles_per_round": {
                     "chain": K2_ROUND_CHAIN_CYCLES,
                     "dispatch": K2_ROUND_DISPATCH_CYCLES,
                     "floor": K2_ROUND_FLOOR_CYCLES},
                 "max_blocks": int(blocks.max()), "blocks": int(blocks.sum()),
                 "ms_size_list": k2_small_ms, "plain_ms_size_list": k2_plain_ms},
          "k3": {"ms": k3_ms, "digests": n_d, "ms_1m_probes_with_upload": k3_1m_ms}})
    emit({"torch_ops": [{
        "name": "cuckoo_probe", "route": "torch",
        "source": "pbs_plus_tpu_torch/ops/cuckoo.py",
        "replaces": "pbs_plus_tpu/ops/cuckoo.py:87",
        "launches": main_launches["cuckoo_probe"], "max_abs_err": 0,
        "ms": k3_ms, "plain_ms": k3_ms, "bound_ms": k3_bound,
        "bound_by": "bytes", "library_ms": k3_ms}]})

    # 8. the kernels line ----------------------------------------------------
    emit({"kernels": [
        {"name": "candidate_mask", "route": "cuda",
         "source": "pbs_plus_tpu_torch/ops/csrc/rolling_hash.cu",
         "replaces": "pbs_plus_tpu/ops/pallas_rolling_hash.py:69",
         "launches": main_launches["candidate_mask"],
         "max_abs_err": int(k1_err > 0),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bound_bytes >= k1_bound_ops else "operations",
         "library_ms": None},
        {"name": "sha256_chunks", "route": "cuda",
         "source": "pbs_plus_tpu_torch/ops/csrc/sha256.cu",
         "replaces": "pbs_plus_tpu/ops/sha256.py:120",
         "launches": main_launches["sha256_chunks"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "plain_shape": f"size list {SHA_SIZES}, kernel {k2_small_ms} ms there",
         "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bound_bytes >= max(k2_bound_ops, k2_bound_floor)
         else "operations",
         "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
