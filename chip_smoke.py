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
   fused_ingest the same streams through 8 FusedIngestStream writers in
              4 MiB pieces and one collector_for(store) at the production
              policy (16 MiB, 4096 chunks, 25 ms): records == the main
              path's cuts and hashlib, new + known == chunks, one K1
              launch per scanning flush, K2 and K3 launched; the flush
              counters and the ingest stage seconds
   store      the same streams as backups through two LocalStores on the
              card at the production defaults, a tpxd datastore (streams
              0-3) and a pbs_format one (streams 4-7): each stream a group
              of files cut at log-uniform sizes of 4 KiB-64 MiB, one
              session per group, all at once; backup #1, then backup #2 of
              the rewritten streams over the previous snapshot; MiB/s,
              new/known chunks, K1/K2/K3 launches, bytes on disk, the zstd
              backend and the free disk; every file read back through
              SplitReader, every stored chunk re-hashed by hashlib, the
              verdicts held against the indexes
   tape       tape ingestion: streams 0-1 cut into files as in the store
              phase, under a few directory levels with one empty
              directory, written as a 512 MiB MTF medium to local disk
              (write_synthetic_mtf); ``python -m pbs_plus_tpu_torch
              mtfprobe`` on it (-v: its dirs, files and bytes), on a copy
              cut by 800 bytes (exit 0 strict and lenient: ESET's header
              survives) and on one without its ESET block (exit 1
              strict, 0 lenient); convert_mtf_to_snapshot into two fresh
              LocalStores on the card (tpxd, pbs_format) twice: #1
              launches K1, K2 and K3, #2 stores no new chunk; every file
              read back through SplitReader, every tpxd entry's digest
              and every stored chunk against hashlib; the medium without
              ESET converts every file, ends in the ESET error and,
              aborted, publishes nothing; MiB/s and seconds a conversion,
              spool spill bytes, launches, new/known chunks
   fleet      the fleet on the card: run_fleet(..., device="cuda") with
              tests/fleet/test_fleet_soak.py's N=500 mixed composition
              (2 backup waves, churn, 50 restores, 50 verifies, 4 syncs,
              5 hostile agents of all five profiles, weighted tenants,
              50 readserve readers) over trees of 2 files of 1 MiB at
              4 MiB average chunks, held to that test's assertions:
              once with a K2 flush a session, once with
              PBS_PLUS_FUSED_INGEST=1 (the fused collector); both runs'
              snapshots equal chunk for chunk, and the first 16 agents'
              equal a 16-agent run_fleet's on the CPU (plain K1,
              hashlib); and run_multiproc_fleet: two ``python -m
              pbs_plus_tpu_torch.server.fleetproc --device cuda`` workers
              on the card over one datastore and one SQLite database (32
              agents each, test_multiproc.py's composition), the GC
              leader SIGKILLed mid-sweep and its lease stolen, held to
              that test's assertions; wall seconds, published MiB/s,
              enqueue->publish p50/p99 (marked at the 10 s top bucket),
              K1/K2/K3 launches (a published MiB), fused flushes by
              trigger, peak device memory, each worker's launches and
              the GC outcomes.  The four runs are interpreters of their
              own (``--fleet-child``), started together: the phase's
              wall is its longest run's, and no later phase sees the
              fleet's process-wide registries.  ``--fleet-only N`` runs
              the build and this phase alone, N times
   verification the verification job (run_verification, sample rate 1.0)
              on each store: whole files through K2 (tpxd) or chunks in
              64 MiB batches (pbs), against hashlib's time and K2's bound;
              then one flipped byte in a payload chunk file, reported as
              chunk:<hex> (pbs) or raised as OSError (tpxd, as the JAX
              package's job does), and flipped back
   sync       datastore replication of both stores into fresh stores on
              the card at sync_batch 1024 (tpxd local to local, pbs over
              a SyncWireServer on loopback): chunks transferred == the
              source's distinct digests, snapshot and chunk files equal,
              every chunk re-hashed by hashlib, the newest snapshots read
              back, K3 launched at least once a probe batch; a second run
              moves nothing; a run broken at pbsstore.sync.commit resumes
              with fewer chunks; pbsstore.sync.transfer=corrupt raises
              SyncError and leaves no torn chunk; MiB/s, probe ms a batch
   mount      each store's newest snapshot of its first group mounted
              (ArchiveView over the shared chunk cache, Journal,
              MutableFS) and committed by CommitEngine on the card: 4 KiB
              writes into 8 files, one file over 32 MiB overwritten, 16
              new files in a new directory, 4 unlinks, a directory
              renamed; commit #1 (K1, K2 and K3 launched), commit #2 after
              two more writes, and commit #3 through an engine that flips
              one bit of one expected digest, which must fail and publish
              nothing; every file read back equals the host's copy, the
              changed files' digests equal hashlib's; seconds per commit
              phase, changed MiB/s, new/known/reused chunks, launches, the
              verify's K2/host split beside hashlib's time and K2's bound
   backup_job the agent backup job end to end: the 8 streams written as
              8 agent trees (files as in the store phase, a symlink, a
              hard link, an excluded file), a port Database with 8 agent
              targets and job rows, AgentsManager + serve on loopback
              (mTLS from the port's CertManager where cryptography
              imports, else the plain loopback mode: "transport"), 8 port
              AgentLifecycles, jobs 0-3 into a tpxd LocalStore on the card
              and 4-7 into a pbs one; backup #1 (8 run_target_backup at
              once), backup #2 after the 4 KiB writes, a job severed by
              backup.file.stream=drop@nth partway and resumed from its
              checkpoint, a local-target job; every file read back, every
              chunk re-hashed, new/known against the indexes, the severed
              and local jobs' files equal to backup #2's; MiB/s a job and
              a store, seconds a job by layer (agent read_at and send,
              the writer's busy time, the publish), K1/K2/K3 launches,
              new/known/reused chunks, bytes on disk
   server     the server shell: one port Server at the production
              defaults (tpxd, chunker "cuda", 4 MiB chunks, keep_last=1)
              started (aRPC over mTLS, the job socket, the scheduler and
              prune loops); 8 agents bootstrapped by token and CSR and
              admitted by their pinned certificates; backup #1 of the
              backup_job phase's 8 trees fired by one scheduler tick (a
              second tick fires nothing), a scheduled verification on
              K2, backup #2 after 4 writes of 4 KiB a tree queued over
              the job socket, prune and GC with the swept and kept
              digests probed through K3, the metrics render, stop();
              every kept file read back, every chunk re-hashed, new/known
              against the index, every job and task row success; MiB/s a
              backup, the job latency histograms' p50/p99, tick, socket,
              verification, prune/GC/discard and render times, the
              device table's update, K1/K2/K3 launches
   kinds      the chunker kinds besides "cuda" against K1's cuts of stream
              0: the native scan built by g++ from chunker/csrc/; stream 0
              through the numpy, native and vector scans and through the
              scalar, vector and sidecar:<addr> streaming chunkers (the
              sidecar a port DedupService on the card over loopback
              gRPC), MiB/s beside K1's; one local-target job per row kind
              ("cpu", "sidecar:<addr>", "cuda") through a port Server:
              every file read back, equal payload indexes, no kernel for
              the cpu job (host chunker, hashlib, the index's host
              mirror), the sidecar's K1/K2 for the sidecar job, K1/K2/K3
              for the cuda job; scan-byte counters and the render show
              no degradation
   web        the port as its users run it: ``python -m pbs_plus_tpu_torch
              server --device cuda --print-token`` and ``... agent``
              (jobs in ``agent-job`` children, ``--snapshots direct``) as
              two processes; the agent enrols over POST
              /plus/agent/bootstrap with the printed token, then over the
              HTTP API: a target and a backup job (the server's default
              chunker, 4 MiB chunks), backup #1 of a 512 MiB tree (files of
              log-uniform sizes, a symlink, a hard link, an excluded
              file), the snapshot listing, a restore to a fresh
              directory (sha256 per file == the source's), a verification
              at rate 1.0 (0 corrupt), the zip of one directory (members
              == its files), backup #2 after 4 writes of 4 KiB (only the
              chunks around the writes stored again), the metrics render
              (K1/K2/K3 launches of the server process > 0); bootstrap
              ms, backup/restore s and MiB/s, verification s beside
              hashlib's, render ms; then a pull sync row over the API
              from the kinds phase's store, run until success, the
              render's pbs_plus_sync_* families above 0; both processes
              stopped at the end, their stderr printed where the phase
              fails
7. sidecar    the route an unmodified backup server takes: DedupService on
              the card, 8 client threads streaming the 8 streams through
              Chunk in 4 MiB pages, InsertIndex of backup #1, backup #2
              and ProbeIndex, Similarity per stream; over loopback gRPC
              (serve_sidecar + SidecarClient) where grpc and msgpack
              import, else the same calls in process
8. similarity SimilarityModel over 10,000 digests: minhash (k=128),
              simhash (k=64), near_duplicates over a 10k x 10k Hamming
              matrix; content sketches of the step's chunks
9. verify     VerifyPipeline: the step's chunks with one byte flipped, one
              stream's bounds, and a snapshot reader with a bad and an
              unreadable chunk at 0 and 4 workers
10. fingerprint fold fingerprints of the step's chunks
11. ingest    the 8 streams' next 32 MiB windows packed into one ragged
              buffer, scanned by one K1 launch, the cut chunks digested
12. parallel  the multi-device layer over meshes that repeat the card: the
              sharded step over 4 (data) x 2 (index) on the 8 streams
              (K1 counts, 4 MiB head digests, the probe of an index
              sharded 2 ways, simhash, the total) against one device,
              hashlib and the host mirror, with its layers timed; the 8
              streams as one 2 GiB stream over 8 sequence-parallel shards
              (masks and cuts against one K1 mask, each shard against the
              plain version); the data-axis fan-in of the ingest windows'
              K1 batch and the step's K2 chunks over 4 devices against
              one; 256 Ki index-sharded probes; the same over the real
              cards where two or more are visible
13. index     the store's DedupIndex on the card at a server's defaults
              (64 MiB table, 256 MiB memtable, spill segments): 4 Mi
              digests preloaded, 512 Ki probed in batches of 1,024 (each
              followed by the insert of its novel half) and 16 Ki in
              batches of 64, every answer held against a Python set; the
              device table's row copies against whole uploads; snapshot,
              reload and boot seconds; discards of every 40th preloaded
              digest; one filter growth
14. dist_index two ``python -m pbs_plus_tpu_torch index-shard`` nodes on the
              card behind the port's DistIndexClient over loopback HTTP:
              512 Ki inserts, 256 Ki probes in batches of 1,024, a rebalance
              to a third node, snapshots on exit
15. similarity_index SimilarityIndex on the card: presketch of the step's
              chunks; sketches and candidates of a sample held against
              the same index on the CPU
16. timings   each kernel's and torch-op program's time, bound, plain and
              library times

then a ``{"torch_ops": [...]}`` and a ``{"kernels": [...]}`` line, the
card's name and power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero;
without a CUDA device it exits non-zero and prints no result.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from types import SimpleNamespace

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
SIM_DIGESTS = 10_000      # BASELINE.json config #5: 10k historical digests
SIM_CORNER = 1000         # Hamming matrix held against numpy on this corner
SIM_MAX_DISTANCE = 6      # near_duplicates' default
CS_SAMPLE = 32            # content sketches held against numpy on these
FP_SAMPLE = 16            # fold fingerprints held against numpy on these
VERIFY_SNAPSHOT_CHUNKS = 48   # chunks behind the snapshot reader
INGEST_WINDOW = 32 << 20  # each stream's window in the fused-ingest batch
STORE_FILE_MIN = 4 << 10  # the store phase's files: log-uniform sizes
STORE_FILE_MAX = 64 << 20
TAPE_STREAMS = 2          # the tape phase's medium: streams 0-1 as files
TAPE_TRUNCATE = 800       # a copy cut by 800 bytes (inside ESET's padding)
MOUNT_WRITES = 8          # the mount phase: 4 KiB writes into 8 files,
MOUNT_WRITE_BYTES = 4 << 10
MOUNT_NEW_FILES = 16      # 16 new files of log-uniform 4 KiB-16 MiB,
MOUNT_NEW_MAX = 16 << 20
MOUNT_UNLINKS = 4         # 4 unlinks
MOUNT_VERIFY_BATCH = None  # None: CommitEngine.VERIFY_BATCH_BYTES (32 MiB)
JOB_CHECKPOINT = "8c"     # the severed job: a checkpoint every 8 chunks
JOB_SEVER_AT = 0.5        # the severed job's drop: this share of its reads
WEB_BYTES = 512 << 20     # the web phase's tree: 512 MiB of files
WEB_DIRS = 8              # in 8 directories
WEB_CHUNK_AVG = None      # None: the server command's default (4 MiB)
WEB_PORT_TIMEOUT = 300.0  # the longest the phase waits on one step
# the index tier at a server's defaults (PBS_PLUS_DEDUP_INDEX_MB=64,
# PBS_PLUS_DEDUP_RESIDENT_MB=256): 4 Mi digests are a 16 TiB datastore of
# 4 MiB chunks, a filter load of 0.5, and spill the 112 B/entry memtable
INDEX_BUDGET_MB = 64
INDEX_RESIDENT_MB = 256
INDEX_PRELOAD = 1 << 22
INDEX_INSERT_BATCH = 1 << 16
INDEX_PROBES = 1 << 19        # in batches of 1,024, half present
INDEX_DISCARD_EVERY = 40      # every 40th preloaded digest discarded
INDEX_SMALL_BATCHES = 256     # batches of 64: a lone writer's flushes
INDEX_RECOVERY_PROBES = 1 << 16
GROW_BUDGET_MB = 8            # grown past its load factor by GROW_INSERTS
GROW_INSERTS = 1 << 20
DIST_INSERTS = 1 << 19        # through two shard nodes
DIST_PROBES = 1 << 18         # in batches of 1,024, half present
SIMI_SAMPLE = 32              # SimilarityIndex sketches held against the CPU
SIMI_VARIANTS = 16            # near-duplicates of the sample's first chunks
# the multi-device layer (phase 12) on the main path's streams, over meshes
# that repeat the card: the step over PAR_DATA x PAR_INDEX with heads of
# STEP_CHUNK bytes, the 2 GiB concatenation over SEQ_SHARDS, the fan-in
# over FAN_IN_DEVICES, PAR_PROBES sharded probes in batches
PAR_DATA, PAR_INDEX = 4, 2
STEP_CHUNK = 4 << 20
SEQ_SHARDS = 8
FAN_IN_DEVICES = 4
PAR_PROBES = 1 << 18
PAR_PROBE_BATCH = 1024
SIM_FLIP_LIMIT = 1e-4     # |float64 score| of a simhash sign that may flip
ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")

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
# the torch-op programs' least operations, int32 unless said otherwise:
# simhash is a float64 [N, 256] @ [256, k] product, bound by the data
# sheet's FP64 tensor-core rate; minhash a multiply-add and a min per
# (digest, hash); Hamming an XOR, a popcount and an add per word pair;
# content sketch per byte a window (1 funnel shift), the first mix (2
# multiplies, 2 shifts, 2 XORs) and the sample test (AND, compare); fold
# fingerprint per 4-byte word a byte swap, a multiply, half an XOR, a
# rotate and the fold's XOR
FP64_FLOPS = 67e12
MINHASH_OPS = 2
HAMMING_OPS = 3
CS_OPS_PER_BYTE = 1 + 6 + 2
FOLD_OPS_PER_BYTE = 4.5 / 4


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One line of output; a phase's line carries the script's seconds so
    far (``elapsed_s``), so that each phase's time is the difference."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - T_START)
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


def sync_all() -> None:
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    """``fn()``'s result and its seconds on the host clock, every card
    synchronised before and after."""
    sync_all()
    t = time.perf_counter()
    r = fn()
    sync_all()
    return r, time.perf_counter() - t


def wall_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the host clock with every card
    synchronised around each run, after one warm-up: the time of work
    spread over several cards, which one card's events do not see."""
    fn()
    return float(np.median([timed(fn)[1] * 1e3 for _ in range(reps)]))


def device_ms(fn):
    """``fn()``'s result and the device time of each kernel it ran, in ms,
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.key] = ms.get(e.key, 0.0) + getattr(
                e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    return r, ms


def top(ms: dict, n: int) -> dict:
    """The ``n`` largest entries of ``ms``, names cut to 100 characters."""
    return {k[:100]: v for k, v in sorted(ms.items(), key=lambda kv: -kv[1])[:n]}


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


def sidecar_wire() -> str:
    """"grpc" where grpc and msgpack import, else "in-process"."""
    try:
        import grpc  # noqa: F401
        import msgpack  # noqa: F401
    except ImportError:
        return "in-process"
    return "grpc"


class InProcessClient:
    """The five sidecar methods as direct handler calls with dicts: the
    sidecar phase's transport where grpc or msgpack is missing."""

    def __init__(self, svc):
        self.svc = svc

    def chunk(self, stream_id, data, *, eof=False):
        return self.svc.chunk({"stream_id": stream_id, "data": data, "eof": eof})

    def probe_index(self, digests):
        return self.svc.probe_index({"digests": digests})["present"]

    def insert_index(self, digests):
        return self.svc.insert_index({"digests": digests})["inserted"]

    def stats(self):
        return self.svc.get_stats({})

    def snapshot_signature(self, digests):
        return self.svc.snapshot_signature({"digests": digests})["signature"]

    def close(self):
        pass


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def hamming_pairs_host(a: np.ndarray, b: np.ndarray, max_distance: int):
    """(i, j, dist) of every pair within ``max_distance``, row-major: a
    numpy popcount table over row blocks, independent of the port."""
    out = []
    for r in range(0, len(a), 500):
        x = (a[r:r + 500, None, :] ^ b[None, :, :]).view(np.uint8)
        d = _POPCOUNT8[x].sum(axis=-1, dtype=np.int32)
        ii, jj = np.nonzero(d <= max_distance)
        out += [(int(i) + r, int(j), int(d[i, j])) for i, j in zip(ii, jj)]
    return out


def digests_of(rng, n: int) -> list[bytes]:
    """``n`` random 32-byte digests (distinct with overwhelming odds)."""
    raw = rng.bytes(32 * n)
    return [raw[i:i + 32] for i in range(0, 32 * n, 32)]


def pct(ms: list[float]) -> dict:
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


class FusedStore:
    """The fused_ingest phase's store: thread-safe, a dict from digest to
    chunk length (no chunk bytes), and a declared batched probe on a
    fresh port ``DedupIndex`` at a server's defaults, so K3 runs on the
    collector's path.  ``new`` and ``known`` count every chunk's verdict."""

    thread_safe = True

    def __init__(self, dev):
        from pbs_plus_tpu_torch.pxar import DedupIndex
        self.index = DedupIndex(device=dev)
        self.lock = threading.Lock()
        self.lengths: dict[bytes, int] = {}     # guarded-by: self.lock
        self.new = 0                            # guarded-by: self.lock
        self.known = 0                          # guarded-by: self.lock

    def ingest_capabilities(self):
        from pbs_plus_tpu_torch.pxar.ingestbackend import IngestCapabilities
        return IngestCapabilities(probe=True, presketch=False)

    def probe_batch(self, digests):
        return self.index.probe_batch(digests)

    def insert(self, digest, chunk, verify=False) -> bool:
        with self.lock:
            if digest in self.lengths:
                self.known += 1
                return False
            self.lengths[digest] = len(chunk)
            self.new += 1
            self.index.insert(digest)
            return True

    def note_dedup_hit(self, digest) -> bool:
        with self.lock:
            self.known += 1
        return True

    def touch(self, digest) -> None:
        pass


def fused_ingest_phase(dev, P, streams: dict, ref_bounds: dict,
                       ref_digests: dict, streaming_mib_s: float) -> dict:
    """Backup #1 of the 8 streams through 8 ``FusedIngestStream`` writers
    and one ``collector_for(store)`` at the production policy, as a
    server with ``PBS_PLUS_FUSED_INGEST`` on runs it: every flush packs
    whatever the writers deposited into one K1 launch, one K2 batch and
    one K3 probe."""
    from pbs_plus_tpu_torch.ops import cuckoo, ingest, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar import FusedIngestStream, collector_for
    from pbs_plus_tpu_torch.pxar import ingestbatch
    from pbs_plus_tpu_torch.utils import trace

    names = sorted(streams)
    for knob in ("PBS_PLUS_INGEST_BATCH_BYTES", "PBS_PLUS_INGEST_MAX_WAIT_MS"):
        os.environ.pop(knob, None)
    store = FusedStore(dev)
    coll = collector_for(store, device=dev)
    check((coll.batch_bytes, coll.batch_chunks, coll.max_wait)
          == (16 << 20, 4096, 0.025), "the collector has the production policy")
    m0, h0 = ingestbatch.metrics_snapshot(), trace.histograms()
    scans0 = ingest.stats["scan_dispatches"]
    rolling_hash.KERNEL.launches = 0
    sha256.KERNEL.launches = 0
    cuckoo.stats["device_probes"] = 0
    out, errs, devs = {}, [], []
    barrier = threading.Barrier(len(names))

    def writer(name):
        try:
            a = streams[name]
            s = FusedIngestStream(store, P, coll)     # registered before any deposit
            barrier.wait()
            for off in range(0, len(a), PIECE_BYTES):
                s.write(a[off:off + PIECE_BYTES].tobytes())
            out[name] = s.finish()
            devs.append(torch.cuda.current_device())
        except BaseException as e:     # surfaced by the check below
            errs.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=writer, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    seconds = time.perf_counter() - t0
    check(not errs and not any(t.is_alive() for t in threads),
          f"fused-ingest writers failed: {errs}")
    launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                "sha256_chunks": sha256.KERNEL.launches,
                "cuckoo_probe": cuckoo.stats["device_probes"]}
    m1, h1 = ingestbatch.metrics_snapshot(), trace.histograms()
    m = {k: m1[k] - m0[k] for k in m0 if k != "occupancy"}
    packed = m["bytes_packed"] + m["padding_bytes"]
    m["occupancy"] = m["bytes_packed"] / packed if packed else 0.0
    scan_flushes = ingest.stats["scan_dispatches"] - scans0
    for n in names:
        check(out[n] == list(zip([e for _, e in ref_bounds[n]], ref_digests[n])),
              f"fused-ingest records of {n} != main path cuts + hashlib")
    chunks = sum(len(out[n]) for n in names)
    distinct = len({d for n in names for d in ref_digests[n]})
    check(store.new + store.known == chunks, "fused ingest: new + known != chunks")
    check(store.new == distinct, "fused ingest: new != distinct digests")
    check(m["chunks"] == chunks and m["failed_flushes"] == 0,
          f"fused-ingest counters: {m}")
    check(launches["candidate_mask"] == scan_flushes > 0,
          f"K1 launches {launches} != scan flushes {scan_flushes}")
    check(launches["sha256_chunks"] > 0 and launches["cuckoo_probe"] > 0,
          f"a kernel of the fused-ingest path did not launch: {launches}")
    check(devs == [0] * len(names), f"flusher threads moved the device: {devs}")
    stages = {}
    for stage in ("fused", "cdc", "sha", "probe"):
        key = f'pbs_plus_ingest_stage_seconds{{stage="{stage}"}}'
        was = h0.get(key, {"count": 0, "sum_s": 0.0})
        stages[stage] = {"count": h1[key]["count"] - was["count"],
                         "sum_s": h1[key]["sum_s"] - was["sum_s"]}
    work_s = sum(stages[s]["sum_s"] for s in ("cdc", "sha", "probe"))
    mib = len(names) * STREAM_BYTES / 2**20
    return {"phase": "fused_ingest", "writers": len(names), "piece": PIECE_BYTES,
            "policy": {"batch_bytes": coll.batch_bytes,
                       "batch_chunks": coll.batch_chunks,
                       "max_wait_s": coll.max_wait, "linger_s": coll.linger},
            "seconds": seconds, "mib_s": mib / seconds,
            "streaming_mib_s": streaming_mib_s,
            "chunks": chunks, "new_chunks": store.new,
            "known_chunks": store.known, "scan_flushes": scan_flushes,
            "metrics": m, "launches": launches, "stage_seconds": stages,
            "sha_share_of_stages": stages["sha"]["sum_s"] / work_s
            if work_s else None}


class SliceReader:
    """A file of a backup: sequential reads over ``a[start:end]``, each
    read one copy of its bytes (as a read of a file is)."""

    def __init__(self, a: np.ndarray, start: int, end: int):
        self.a, self.pos, self.end = a, start, end

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.end - self.pos
        out = self.a[self.pos:min(self.end, self.pos + n)].tobytes()
        self.pos += len(out)
        return out


async def stop_lifecycles(lifecycles) -> None:
    """Stop the agents, then cancel and await every other task of their
    event loop."""
    for lc in lifecycles:
        await lc.stop()
    others = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
    for t in others:
        t.cancel()
    await asyncio.gather(*others, return_exceptions=True)


def store_files(n: int, seed: int) -> list[tuple[int, int]]:
    """A stream of ``n`` bytes cut into files of log-uniform sizes in
    [STORE_FILE_MIN, STORE_FILE_MAX] (the last one shorter)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log(STORE_FILE_MIN), np.log(STORE_FILE_MAX)
    bounds, off = [], 0
    while off < n:
        size = int(np.exp(rng.uniform(lo, hi)))
        bounds.append((off, min(n, off + size)))
        off += size
    return bounds


def dir_bytes(path: str) -> int:
    total = 0
    for dp, _dn, fn in os.walk(path):
        total += sum(os.path.getsize(os.path.join(dp, f)) for f in fn)
    return total


def store_phase(dev, P, streams: dict, seed: int, root: str) -> tuple[dict, dict]:
    """The 8 streams as backups through two port ``LocalStore``s on the
    card at the production defaults: the native ``tpxd`` datastore takes
    streams 0-3, a ``pbs_format=True`` one streams 4-7.  Each stream is
    one group ``host/<name>``, a tree of files cut from it at log-uniform
    sizes, written by one session per group, all of a store's groups at
    once.  Backup #1, then backup #2 of the rewritten streams with the
    previous snapshot picked automatically.  Every file is read back
    through the port's ``SplitReader``, every stored chunk re-hashed by
    hashlib, and the new/known verdicts held against the snapshots'
    indexes.  Returns the phase line and the stores for the verification
    phase."""
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar import datastore as port_ds
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader

    names = sorted(streams)
    free = shutil.disk_usage(root).free
    files = {n: store_files(STREAM_BYTES, seed + 100 + k)
             for k, n in enumerate(names)}
    streams2 = rewrite(streams, seed)
    half = len(names) // 2
    layout = {"tpxd": names[:half], "pbs": names[half:]}
    out = {"phase": "store", "free_disk_bytes_before": free,
           "zstd_backend": port_ds.zstandard.__name__,
           "params": [P.avg_size, P.min_size, P.max_size],
           "files": {n: len(files[n]) for n in names},
           "largest_file": max(e - s for n in names for s, e in files[n]),
           "stores": {}}
    stores = {}
    for kind, groups in layout.items():
        base = os.path.join(root, kind)
        ls = LocalStore(base, P, pbs_format=kind == "pbs", device=dev)
        ds = ls.datastore
        runs, seen = [], set()
        for b, strs in enumerate((streams, streams2)):
            mans, errs = {}, []
            barrier = threading.Barrier(len(groups))

            def session(name, strs=strs, b=b, mans=mans, errs=errs,
                        barrier=barrier):
                try:
                    barrier.wait()
                    sess = ls.start_session(backup_type="host",
                                            backup_id=name,
                                            backup_time=1_700_000_000 + 3600 * b)
                    w = sess.writer
                    w.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
                    w.write_entry(Entry(path="d", kind=KIND_DIR, mode=0o40755))
                    a = strs[name]
                    for i, (s, e) in enumerate(files[name]):
                        w.write_entry_reader(
                            Entry(path=f"d/f{i:05d}", kind=KIND_FILE,
                                  mode=0o100644, size=e - s),
                            SliceReader(a, s, e))
                    mans[name] = sess.finish()
                except BaseException as e:     # surfaced by the check below
                    errs.append(repr(e))

            rolling_hash.KERNEL.launches = 0
            sha256.KERNEL.launches = 0
            cuckoo.stats["device_probes"] = 0
            threads = [threading.Thread(target=session, args=(n,))
                       for n in groups]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            secs = time.perf_counter() - t0
            launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                        "sha256_chunks": sha256.KERNEL.launches,
                        "cuckoo_probe": cuckoo.stats["device_probes"]}
            check(not errs and not any(t.is_alive() for t in threads),
                  f"{kind} backup #{b + 1} sessions failed: {errs}")
            check(all(v > 0 for v in launches.values()),
                  f"a kernel of the {kind} store path did not launch: {launches}")
            check(all(mans[n]["previous"] == (
                f"host/{n}/{port_ds.format_backup_time(1_700_000_000)}"
                if b else None) for n in groups),
                f"{kind} backup #{b + 1} previous snapshots: "
                f"{[mans[n]['previous'] for n in groups]}")
            # each distinct digest of this backup's indexes is new exactly
            # once, unless an earlier backup of the store holds it
            digs = set()
            for n in groups:
                ref = ds.last_snapshot("host", n)
                for idx in ds.load_indexes(ref):
                    digs.update(idx.digest(i) for i in range(len(idx)))
            new = sum(mans[n]["stats"]["new_chunks"] for n in groups)
            known = sum(mans[n]["stats"]["known_chunks"] for n in groups)
            chunks = sum(mans[n]["meta_chunks"] + mans[n]["payload_chunks"]
                         for n in groups)
            check(new == len(digs - seen) and new + known == chunks,
                  f"{kind} backup #{b + 1}: new {new}, known {known}, "
                  f"chunks {chunks}, novel digests {len(digs - seen)}")
            if b:
                check(known > 0 and new < chunks // 2,
                      f"{kind} backup #2 did not find the unchanged chunks "
                      f"known: new {new}, known {known}")
            seen |= digs
            nbytes = len(groups) * STREAM_BYTES
            runs.append({"seconds": secs, "mib_s": nbytes / 2**20 / secs,
                         "new_chunks": new, "known_chunks": known,
                         "chunks": chunks, "launches": launches,
                         "bytes_on_disk": dir_bytes(base),
                         "chunk_bytes_on_disk": dir_bytes(ds.chunks.base)})
        # every file of both backups reads back through the SplitReader
        t0 = time.perf_counter()
        read = 0
        for b, strs in enumerate((streams, streams2)):
            for n in groups:
                ref = [r for r in ds.list_snapshots("host", n)][b]
                rd = SplitReader.open_snapshot(ds, ref)
                ents = [e for e in rd.entries() if e.is_file]
                check([e.path for e in ents] ==
                      [f"d/f{i:05d}" for i in range(len(files[n]))],
                      f"{kind} {ref}: entries")
                a = strs[n]
                for e, (s, t) in zip(ents, files[n]):
                    got = rd.read_file(e)
                    check(e.size == t - s and np.array_equal(
                        np.frombuffer(got, np.uint8), a[s:t]),
                        f"{kind} {ref} {e.path} does not read back")
                    read += len(got)
        read_s = time.perf_counter() - t0
        # every stored chunk, decompressed, hashes to its name
        stored = list(ds.chunks.iter_digests())

        def rehash(d):
            return hashlib.sha256(ds.chunks.get(d)).digest() == d

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            ok = list(pool.map(rehash, stored))
        check(all(ok) and set(stored) == seen,
              f"{kind}: stored chunks != hashlib or != the indexes' digests")
        out["stores"][kind] = {"groups": groups, "backups": runs,
                               "read_back_bytes": read, "read_back_s": read_s,
                               "stored_chunks": len(stored),
                               "rehash_s": time.perf_counter() - t0}
        stores[kind] = SimpleNamespace(store=ls, groups=groups,
                                       streams=(streams, streams2),
                                       files=files)
    return out, stores


def _probe(path: str, *flags: str) -> subprocess.Popen:
    """``python -m pbs_plus_tpu_torch mtfprobe`` on ``path`` as a process."""
    return subprocess.Popen(
        [sys.executable, "-m", "pbs_plus_tpu_torch", "mtfprobe", path,
         *flags], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))


def _tape_store(dev, P, base: str, pbs: bool, media: str, files: dict,
                dirs: set, spools: list) -> tuple[dict, object]:
    """Conversions #1 and #2 of ``media`` into one port LocalStore on the
    card, #1 read back: its line and the store."""
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader
    from pbs_plus_tpu_torch.tapeio import converter

    kind = "pbs" if pbs else "tpxd"
    nbytes = sum(map(len, files.values()))
    ls = LocalStore(base, P, pbs_format=pbs, device=dev)
    ds = ls.datastore
    runs = []
    for b in range(2):
        rolling_hash.KERNEL.launches = 0
        sha256.KERNEL.launches = 0
        cuckoo.stats["device_probes"] = 0
        spools.clear()
        sess = ls.start_session(backup_type="host", backup_id="tape",
                                backup_time=1_700_000_000 + 3600 * b)
        t0 = time.perf_counter()
        with open(media, "rb") as f:
            res = converter.convert_mtf_to_snapshot(f, sess)
        man = sess.finish({"source_media": "LTO001"})
        secs = time.perf_counter() - t0
        launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                    "sha256_chunks": sha256.KERNEL.launches,
                    "cuckoo_probe": cuckoo.stats["device_probes"]}
        st = man["stats"]
        check(res.files == len(files) and res.bytes == nbytes
              and not res.errors,
              f"tape {kind} #{b + 1}: {res.files} files, {res.bytes} bytes, "
              f"errors {res.errors[:3]}")
        if b == 0:
            check(all(v > 0 for v in launches.values()),
                  f"a kernel of the tape {kind} path did not launch: "
                  f"{launches}")
        else:
            check(st["new_chunks"] == 0,
                  f"tape {kind} #2 stored {st['new_chunks']} new chunks")
        runs.append({"seconds": secs, "mib_s": nbytes / 2**20 / secs,
                     "convert_s": res.seconds,
                     "new_chunks": st["new_chunks"],
                     "known_chunks": st["known_chunks"],
                     "chunks": man["meta_chunks"] + man["payload_chunks"],
                     "spools": len(spools),
                     "spilled_bytes": sum(s.stats["spilled"] for s in spools),
                     "launches": launches})
    # #1 reads back; tpxd entries carry hashlib's digest (pbs ones, pxar
    # v2, carry none), and every stored chunk hashes to its name
    t0 = time.perf_counter()
    rd = SplitReader.open_snapshot(ds, ds.list_snapshots("host", "tape")[0])
    ents = {e.path: e for e in rd.entries()}
    check(dirs <= {p for p, e in ents.items() if e.is_dir}
          and set(files) == {p for p, e in ents.items() if e.is_file},
          f"tape {kind}: entries")
    for p, data in files.items():
        e = ents[p]
        check(rd.read_file(e) == data, f"tape {kind} {p} does not read back")
        if not pbs:
            check(e.digest == hashlib.sha256(data).digest(),
                  f"tape {kind} {p}: digest != hashlib")
    read_s = time.perf_counter() - t0
    stored = list(ds.chunks.iter_digests())
    with ThreadPoolExecutor(8) as pool:
        ok = list(pool.map(
            lambda d: hashlib.sha256(ds.chunks.get(d)).digest() == d, stored))
    check(stored and all(ok), f"tape {kind}: stored chunks != hashlib")
    return {"conversions": runs, "read_back_s": read_s,
            "stored_chunks": len(stored),
            "bytes_on_disk": dir_bytes(ds.base)}, ls


def _tape_truncated(ls, media: str, n_files: int) -> dict:
    """The medium without ESET into the store: every file converts, the
    ESET error ends the list, and the aborted session publishes nothing."""
    from pbs_plus_tpu_torch.tapeio import converter

    ds = ls.datastore
    before = ds.list_snapshots()
    sess = ls.start_session(backup_type="host", backup_id="tape-trunc")
    t0 = time.perf_counter()
    with open(media, "rb") as f:
        res = converter.convert_mtf_to_snapshot(f, sess)
    sess.abort()
    check(res.files == n_files and res.errors and "ESET" in res.errors[-1]
          and ds.list_snapshots() == before,
          f"tape without ESET: {res.files} files, errors {res.errors[-3:]}, "
          f"snapshots {ds.list_snapshots()}")
    return {"seconds": time.perf_counter() - t0, "files": res.files,
            "errors": res.errors, "published": False}


def tape_phase(dev, P, streams: dict, seed: int, root: str) -> dict:
    """Tape ingestion on the card: streams 0-1 cut into files (as in the
    store phase) under a few directory levels with one empty directory,
    written as one MTF medium to local disk by ``write_synthetic_mtf``;
    ``mtfprobe`` (the port's command) on it, on a copy cut by 800 bytes
    and on one without its ESET block, strict and lenient; the medium
    converted twice into each of two port ``LocalStore(device=dev)`` at
    the production defaults (tpxd and pbs_format); #1 launches K1, K2 and
    K3, #2 stores no new chunk; every file read back through SplitReader,
    every tpxd entry's digest and every stored chunk against hashlib;
    the medium without ESET converts every file, ends in the ESET error
    and, aborted, publishes nothing."""
    from pbs_plus_tpu_torch.tapeio import converter, write_synthetic_mtf

    t_phase = time.perf_counter()
    tree = {"tape/empty": None}
    for k, n in enumerate(sorted(streams)[:TAPE_STREAMS]):
        a = streams[n]
        for i, (s, e) in enumerate(store_files(STREAM_BYTES, seed + 100 + k)):
            tree[f"tape/s{k}/d{i % 4}/e{i % 3}/f{i:05d}"] = a[s:e].tobytes()
    files = {p: v for p, v in tree.items() if v is not None}
    dirs = {p for p, v in tree.items() if v is None}
    for p in files:
        parts = p.split("/")[:-1]
        dirs.update("/".join(parts[:i]) for i in range(1, len(parts) + 1))
    nbytes = sum(map(len, files.values()))
    media = os.path.join(root, "media.bkf")
    t0 = time.perf_counter()
    with open(media, "wb") as f:
        write_synthetic_mtf(f, tree, media_name="LTO001")
    del tree
    out = {"phase": "tape", "files": len(files), "dirs": len(dirs),
           "bytes": nbytes, "media_bytes": os.path.getsize(media),
           "largest_file": max(map(len, files.values())),
           "media_write_s": time.perf_counter() - t0, "stores": {}}
    cut, no_eset = media + ".cut800", media + ".noeset"
    for path, k in ((cut, TAPE_TRUNCATE), (no_eset, 1024)):
        shutil.copyfile(media, path)
        os.truncate(path, out["media_bytes"] - k)
    # the probes run beside the conversions, as processes of their own
    probes = {"intact_v": _probe(media, "-v"), "cut800": _probe(cut),
              "cut800_lenient": _probe(cut, "--lenient"),
              "no_eset": _probe(no_eset),
              "no_eset_lenient": _probe(no_eset, "--lenient")}
    spools, plain_spool = [], converter.Spool

    class CountingSpool(plain_spool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            spools.append(self)

    converter.Spool = CountingSpool
    try:
        for pbs in (False, True):
            kind = "pbs" if pbs else "tpxd"
            out["stores"][kind], ls = _tape_store(
                dev, P, os.path.join(root, kind), pbs, media, files, dirs,
                spools)
            if not pbs:
                out["no_eset"] = _tape_truncated(ls, no_eset, len(files))
            del ls
        res = {}
        for k, p in probes.items():
            so, se = p.communicate(timeout=300)
            res[k] = (p.returncode, so, se)
    finally:
        converter.Spool = plain_spool
        for p in probes.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    # mtfprobe: the intact medium's dirs, files and bytes; the copy cut by
    # 800 bytes keeps ESET's header, so the reader ends the set there and
    # exits 0 even strict (as the JAX package's does); without ESET, strict
    # exits 1 and lenient 0
    summary = f"{len(dirs)} dirs, {len(files)} files, {nbytes} content bytes"
    rc, so, se = res["intact_v"]
    lines = so.splitlines()
    check(rc == 0 and lines[-1:] == [f"{media}: {summary}"]
          and len(lines) == len(dirs) + len(files) + 1,
          f"mtfprobe -v: rc {rc}, {lines[-1:]} {se[-2000:]}")
    for k, path, want in (("cut800", cut, 0), ("cut800_lenient", cut, 0),
                          ("no_eset", no_eset, 1),
                          ("no_eset_lenient", no_eset, 0)):
        rc, so, se = res[k]
        line = ("MTF error: media ended without ESET (truncated tape?)"
                if want else f"{path}: {summary}")
        check(rc == want and so == line + "\n",
              f"mtfprobe {k}: rc {rc}, {so[-300:]!r} {se[-2000:]}")
    out["mtfprobe"] = {k: {"rc": v[0], "last_line": v[1].splitlines()[-1]}
                       for k, v in res.items()}
    out["launches"] = {k: sum(r["launches"][k]
                              for st in out["stores"].values()
                              for r in st["conversions"])
                       for k in ("candidate_mask", "sha256_chunks",
                                 "cuckoo_probe")}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# the fleet phase: tests/fleet/test_fleet_soak.py's _mixed_cfg(500) and
# tests/fleet/test_multiproc.py's composition at the production chunk size
FLEET_AGENTS = 500
FLEET_FILES = 2                # a host's tree: 2 files of 1 MiB
FLEET_FILE_BYTES = 1 << 20
FLEET_CHUNK_AVG = 4 << 20      # the production chunking (1-16 MiB)
FLEET_SAMPLE = 16              # agents held against a LocalStore on the CPU
FLEET_MP_AGENTS = 32           # agents a fleetproc worker
FLEET_PROFILES = "flood,slow_reader,reconnect_storm,length_liar,slowloris"


def fleet_config(FleetConfig):
    """``_mixed_cfg(FLEET_AGENTS)`` of ``tests/fleet/test_fleet_soak.py``
    (lines 164-190), with the bytes of a host at the production chunk
    size."""
    n = FLEET_AGENTS
    return FleetConfig(
        n_agents=n, tenants=8, max_concurrent=8, max_queued=4 * n,
        jobs_per_agent=2, churn_fraction=0.1,
        restore_jobs=max(4, n // 10), verify_jobs=max(4, n // 10),
        sync_jobs=4, hostile_agents=5, hostile_profiles=FLEET_PROFILES,
        reservation_ttl_s=1.0, mux_write_deadline_s=2.0,
        tenant_weights="tenant-0=3,tenant-1=2",
        readserve_readers=max(4, n // 10), readserve_reads=6,
        files_per_agent=FLEET_FILES, file_size=FLEET_FILE_BYTES,
        chunk_avg=FLEET_CHUNK_AVG)


def mixed_assertions(cfg, rep, d: dict, what: str) -> None:
    """``_mixed_assertions`` of ``tests/fleet/test_fleet_soak.py`` (lines
    193-246) as checks."""
    check(d["published"] == cfg.n_agents * cfg.jobs_per_agent
          and not rep.failures,
          f"{what}: published {d['published']}, failures "
          f"{dict(list(rep.failures.items())[:5])}")
    check(d["restore_completed"] == cfg.restore_jobs
          and d["restore_failed"] == 0, f"{what}: restores "
          f"{d['restore_completed']}, {dict(list(rep.restore_failures.items())[:3])}")
    check(d["verify_completed"] == cfg.verify_jobs
          and d["verify_failed"] == 0, f"{what}: verifies "
          f"{d['verify_completed']}, {dict(list(rep.verify_failures.items())[:3])}")
    check(d["sync_completed"] >= cfg.sync_jobs and d["sync_failed"] == 0,
          f"{what}: syncs {d['sync_completed']}, {rep.sync_failures}")
    check(d["churned"] >= 1, f"{what}: no churn")
    check(d["readserve_completed"] == cfg.readserve_readers
          and d["readserve_failed"] == 0
          and d["readserve_reads"] == cfg.readserve_readers
          * cfg.readserve_reads and d["readserve_bytes"] > 0
          and d["readserve_cache"].get("hits", 0) > 0,
          f"{what}: readserve {d['readserve_completed']} "
          f"{d['readserve_reads']} {d['readserve_cache']} "
          f"{dict(list(rep.readserve_failures.items())[:3])}")
    check(d["hostile_run"] == cfg.hostile_agents
          and d["server_flow_violations"] >= 1
          and d["server_write_deadline_sheds"] >= 1
          and d["server_stream_length_violations"] >= 1
          and d["hostile_liar_errors"] >= 1
          and d["hostile_liar_published"] == 0 and d["evictions"] >= 1
          and d["reservations_reaped"] >= cfg.hostile_slowloris_rounds,
          f"{what}: hostiles {d['hostile_run']}, flow "
          f"{d['server_flow_violations']}, sheds "
          f"{d['server_write_deadline_sheds']}, length "
          f"{d['server_stream_length_violations']}, liar "
          f"{d['hostile_liar_errors']}/{d['hostile_liar_published']}, "
          f"evictions {d['evictions']}, reaped {d['reservations_reaped']}")
    check(all(rep.tenant_grants.get(f"tenant-{t}", 0) > 0
              for t in range(cfg.tenants)),
          f"{what}: a tenant starved: {rep.tenant_grants}")
    check(0 < d["enqueue_to_publish_p50_s"] <= d["enqueue_to_publish_p99_s"],
          f"{what}: enqueue->publish p50/p99 {d['enqueue_to_publish_p50_s']}"
          f"/{d['enqueue_to_publish_p99_s']}")
    check(not d["bound_violated"] and d["queued_max"] <= cfg.max_queued,
          f"{what}: queue bound {d['queued_max']} > {cfg.max_queued}")


def fair_shares(order: list, jobs_per_tenant: int, weights: dict) -> bool:
    """``_fair_shares`` of ``tests/fleet/test_multiproc.py``: +-10% over
    the all-backlogged prefix of the contended grant order."""
    left = {t: jobs_per_tenant for t in weights}
    prefix = []
    for t in order:
        prefix.append(t)
        left[t] -= 1
        if left[t] == 0:
            break
    total_w = sum(weights.values())
    return all(abs(prefix.count(t) - len(prefix) * w / total_w)
               <= 0.1 * len(prefix) * w / total_w + 1
               for t, w in weights.items())


def snapshot_digests(ds) -> dict:
    """"<backup_id>#<n-th snapshot of its group>" -> each index's
    [[end, digest hex]] (JSON as it is)."""
    out, seen = {}, {}
    for ref in sorted(ds.list_snapshots(), key=lambda r: (r.backup_id,
                                                           r.backup_time)):
        k = seen[ref.backup_id] = seen.get(ref.backup_id, -1) + 1
        out[f"{ref.backup_id}#{k}"] = [
            [[int(ix.ends[i]), bytes(ix.digests[i]).hex()]
             for i in range(len(ix.ends))] for ix in ds.load_indexes(ref)]
    return out


def _fleet_run(dev, cfg, root: str, fused: bool) -> tuple[dict, dict]:
    """One ``run_fleet(..., device=dev)`` (``PBS_PLUS_FUSED_INGEST`` as
    ``fused`` says), held to the soak's own assertions: its line and the
    chunk digests of its snapshots."""
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar import ingestbatch
    from pbs_plus_tpu_torch.pxar.datastore import Datastore
    from pbs_plus_tpu_torch.server import fleetsim, metrics
    from pbs_plus_tpu_torch.utils import conf

    what = f"fleet survival ({'fused' if fused else 'sessions'})"
    if fused:
        os.environ["PBS_PLUS_FUSED_INGEST"] = "1"
    else:
        os.environ.pop("PBS_PLUS_FUSED_INGEST", None)
    for knob in ("PBS_PLUS_INGEST_BATCH_BYTES", "PBS_PLUS_INGEST_MAX_WAIT_MS"):
        os.environ.pop(knob, None)
    conf.env.cache_clear()
    ds_dir = os.path.join(root, "ds")
    m0 = ingestbatch.metrics_snapshot()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rolling_hash.KERNEL.launches = 0
    sha256.KERNEL.launches = 0
    cuckoo.stats["device_probes"] = 0
    t0 = time.perf_counter()
    rep = fleetsim.run_fleet(ds_dir, cfg, device=dev)
    wall = time.perf_counter() - t0
    print(f"{what}: run_fleet returned in {wall:.1f} s", file=sys.stderr,
          flush=True)
    launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                "sha256_chunks": sha256.KERNEL.launches,
                "cuckoo_probe": cuckoo.stats["device_probes"]}
    d = rep.to_dict()
    mixed_assertions(cfg, rep, d, what)
    # the wrappers launch on the card (on the CPU they run the plain versions)
    check(dev.type != "cuda" or all(v > 0 for v in launches.values()),
          f"{what}: a kernel of the fleet path did not launch: {launches}")
    m1 = ingestbatch.metrics_snapshot()
    m = {k: m1[k] - m0[k] for k in m0 if k != "occupancy"}
    if fused:
        check(m["flushes"] > 0 and m["failed_flushes"] == 0,
              f"{what}: fused flushes {m}")
    else:
        check(m["flushes"] == 0, f"{what}: fused flushes without the knob {m}")
    digests = snapshot_digests(Datastore(ds_dir, dedup_index_mb=0, device=dev))
    hostile = [k for k in digests if not k.startswith("sim-")]
    check(len(digests) == d["published"] and not hostile,
          f"{what}: {len(digests)} snapshots, hostile ones {hostile}")
    mib = d["published"] * cfg.files_per_agent * cfg.file_size / 2**20
    top = metrics.HIST_BUCKETS[-1]
    line = {"wall_s": wall, "published_mib": mib,
            "published_mib_s": mib / wall,
            "enqueue_to_publish_s": {
                "p50": d["enqueue_to_publish_p50_s"],
                "p99": d["enqueue_to_publish_p99_s"],
                "top_bucket_s": top,
                "p50_at_top_bucket": d["enqueue_to_publish_p50_s"] >= top,
                "p99_at_top_bucket": d["enqueue_to_publish_p99_s"] >= top},
            "launches": launches,
            "launches_per_published_mib": {k: v / mib
                                           for k, v in launches.items()},
            "fused_flushes": {"total": m["flushes"],
                              "linger": m["linger_flushes"],
                              "deadline": m["deadline_flushes"],
                              "size_or_all_deposited": m["flushes"]
                              - m["linger_flushes"] - m["deadline_flushes"],
                              "rows": m["rows"], "chunks": m["chunks"],
                              "sessions_packed": m["sessions_packed"]},
            "peak_device_mib": torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None,
            "report": d}
    return line, digests


def _fleet_cpu_run(cfg, root: str) -> tuple[dict, dict]:
    """The first ``FLEET_SAMPLE`` agents of the fleet (the same trees:
    ``synthetic_tree(seed, i)``), one wave, through ``run_fleet`` on the
    CPU: ``RemoteTreeBackup`` over the agentfs wire into a port
    ``LocalStore`` whose sessions cut with the plain K1 and hash inline
    with hashlib (a chunker factory and no batch hasher)."""
    from pbs_plus_tpu_torch.models import make_chunker_factory
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.datastore import Datastore
    from pbs_plus_tpu_torch.server import fleetsim

    class HashlibStore(LocalStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, chunker_factory=make_chunker_factory(
                "cuda", device="cpu"), **kw)
            check(self.batch_hasher is None, "the CPU store hashes with "
                                             "hashlib")

    fleetsim.LocalStore = HashlibStore
    sample = fleetsim.FleetConfig(
        n_agents=FLEET_SAMPLE, tenants=cfg.tenants,
        max_concurrent=cfg.max_concurrent, seed=cfg.seed,
        files_per_agent=cfg.files_per_agent, file_size=cfg.file_size,
        chunk_avg=cfg.chunk_avg)
    ds_dir = os.path.join(root, "ds")
    t0 = time.perf_counter()
    rep = fleetsim.run_fleet(ds_dir, sample, device="cpu")
    seconds = time.perf_counter() - t0
    check(rep.published == FLEET_SAMPLE and not rep.failures,
          f"fleet cpu: published {rep.published}, {rep.failures}")
    digests = snapshot_digests(Datastore(ds_dir, dedup_index_mb=0,
                                         device="cpu"))
    return {"agents": FLEET_SAMPLE, "seconds": seconds}, digests


# the fleet phase's runs, each in an interpreter of its own, all started
# at once: the metrics histograms, the trace ring, the failpoints and the
# chunk cache are process-wide, and the later phases read them
FLEET_RUNS = ("sessions", "fused", "multiproc", "cpu")
FLEET_TIMEOUT = 600.0


def fleet_child(kind: str, root: str) -> int:
    """One of ``FLEET_RUNS`` (``main`` has set the phase's sizes): writes
    ``{"line": ..., "digests": ...}`` (or ``{"error": ...}``) to
    ``root/out.json``."""
    from pbs_plus_tpu_torch.server import fleetsim

    out = os.path.join(root, "out.json")
    cfg = fleet_config(fleetsim.FleetConfig)
    try:
        if kind == "multiproc":
            res = {"line": fleet_multiproc(torch.device(DEVICE), root)}
        elif kind == "cpu":
            line, digests = _fleet_cpu_run(cfg, root)
            res = {"line": line, "digests": digests}
        else:
            line, digests = _fleet_run(torch.device(DEVICE), cfg, root,
                                       kind == "fused")
            res = {"line": line, "digests": digests}
    except CheckFailed as e:
        res = {"error": str(e)}
    with open(out, "w") as f:
        json.dump(res, f)
    return 0 if "line" in res else 1


def fleet_phase(dev, root: str) -> dict:
    """The fleet on the card: the JAX package's N=500 survival soak
    (``run_fleet``) twice, per-session K2 flushes and then
    ``PBS_PLUS_FUSED_INGEST=1``, both held to the soak's assertions and
    to each other's chunk digests, the first 16 agents' to a CPU
    fleet's; and the two-process shared datastore
    (``run_multiproc_fleet``: two ``fleetproc`` workers on the card over
    one datastore and one SQLite database, the GC leader SIGKILLed) held
    to ``test_multiproc.py``'s assertions.  The four runs are
    ``fleet_child`` interpreters, started together; each is its own
    process group, killed whole at the end."""
    import signal
    from pbs_plus_tpu_torch.server import fleetsim

    t_phase = time.perf_counter()
    cfg = fleet_config(fleetsim.FleetConfig)
    out = {"phase": "fleet", "config": {
        "n_agents": cfg.n_agents, "tenants": cfg.tenants,
        "max_concurrent": cfg.max_concurrent, "max_queued": cfg.max_queued,
        "jobs_per_agent": cfg.jobs_per_agent, "files_per_agent":
        cfg.files_per_agent, "file_size": cfg.file_size,
        "chunk_avg": cfg.chunk_avg, "restore_jobs": cfg.restore_jobs,
        "verify_jobs": cfg.verify_jobs, "sync_jobs": cfg.sync_jobs,
        "hostile_profiles": cfg.hostile_profiles,
        "readserve": [cfg.readserve_readers, cfg.readserve_reads]},
        "runs": "concurrent, one interpreter each", "survival": {}}
    sizes = json.dumps({k: globals()[k] for k in (
        "DEVICE", "FLEET_AGENTS", "FLEET_FILES", "FLEET_FILE_BYTES",
        "FLEET_CHUNK_AVG", "FLEET_SAMPLE", "FLEET_MP_AGENTS")})
    procs, res = {}, {}
    try:
        for kind in FLEET_RUNS:
            d = os.path.join(root, kind)
            os.makedirs(d)
            with open(os.path.join(d, "log"), "w") as log:
                procs[kind] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--fleet-child", kind, d, sizes],
                    cwd=ROOT, stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True)
        t_end = time.monotonic() + FLEET_TIMEOUT
        for kind, p in procs.items():
            try:
                rc = p.wait(timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            d = os.path.join(root, kind)
            try:
                with open(os.path.join(d, "out.json")) as f:
                    res[kind] = json.load(f)
            except OSError:
                res[kind] = {}
            check(rc == 0 and "line" in res[kind],
                  f"fleet {kind}: exit {rc}: "
                  f"{res[kind].get('error') or _tail(os.path.join(d, 'log'))}")
    finally:
        for p in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    print(f"fleet: runs done in {time.perf_counter() - t_phase:.1f} s",
          file=sys.stderr, flush=True)
    for name in ("sessions", "fused"):
        out["survival"][name] = res[name]["line"]
    runs = {name: res[name]["digests"] for name in ("sessions", "fused")}
    check(runs["sessions"] == runs["fused"],
          "fleet: the fused run's snapshots differ from the sessions run's: "
          f"{sorted(k for k in runs['sessions'] if runs['sessions'][k] != runs['fused'].get(k))[:5]}")
    cpu = res["cpu"]["digests"]
    check(sorted(cpu) == [f"sim-{i:04d}#0" for i in range(FLEET_SAMPLE)],
          f"fleet: the CPU fleet's snapshots {sorted(cpu)[:4]}")
    for k in cpu:
        check(cpu[k] == runs["sessions"][k],
              f"fleet: {k}'s snapshot on the card != the CPU fleet's")
    out["cpu_sample"] = dict(res["cpu"]["line"], equal=True)
    out["multiproc"] = res["multiproc"]["line"]
    out["launches"] = {k: sum(r["launches"][k]
                              for r in out["survival"].values())
                       + sum(w[k] for w in
                             out["multiproc"]["worker_launches"].values())
                       for k in ("candidate_mask", "sha256_chunks",
                                 "cuckoo_probe")}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# loaded first by every fleetproc worker of the phase (a sitecustomize on
# PYTHONPATH): an import of jax or of the JAX package raises and is
# written down; the machine's own sitecustomize, if any, runs after it
_WORKER_GATE = r'''
import os, sys

_BLOCKED = ("jax", "jaxlib", "pbs_plus_tpu")
_HERE = os.path.dirname(os.path.abspath(__file__))


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            with open(os.path.join(_HERE, "blocked.txt"), "a") as f:
                f.write(f"{os.getpid()} {name}\n")
            raise ImportError("blocked in a fleetproc worker: " + name)
        return None


sys.meta_path.insert(0, _Block())
for _d in sys.path:
    _f = os.path.join(_d or ".", "sitecustomize.py")
    if os.path.abspath(_d or ".") != _HERE and os.path.isfile(_f):
        with open(_f) as _src:
            exec(compile(_src.read(), _f, "exec"),
                 {"__name__": "sitecustomize", "__file__": _f})
        break
'''


def fleet_multiproc(dev, root: str) -> dict:
    """``run_multiproc_fleet`` with ``tests/fleet/test_multiproc.py``'s
    composition (lines 64-78) at ``FLEET_MP_AGENTS`` agents a worker and
    the fleet's bytes, on the card; that test's assertions.  The workers
    run with jax and the JAX package unimportable (``_WORKER_GATE``)."""
    from pbs_plus_tpu_torch.server import fleetsim

    cfg = fleetsim.MultiProcConfig(
        n_agents=FLEET_MP_AGENTS, files_per_agent=FLEET_FILES,
        file_size=FLEET_FILE_BYTES, chunk_avg=FLEET_CHUNK_AVG,
        shared_fraction=0.5, gc_ttl_s=2.0, kill_slow_sweep_s=8.0,
        kill_leader=True, jobs_per_agent=2,
        restore_jobs=min(4, FLEET_MP_AGENTS),
        verify_jobs=min(4, FLEET_MP_AGENTS), sync_jobs=2,
        hostile_agents=5, hostile_profiles=FLEET_PROFILES,
        tenant_weights="tenant-0=3", admission_deadline_ms=500.0,
        reservation_ttl_s=1.0, fair_probe=True, deadline_probe=True)
    site = os.path.join(root, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_WORKER_GATE)
    path0 = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = site + (os.pathsep + path0 if path0 else "")
    t0 = time.perf_counter()
    try:
        rep = fleetsim.run_multiproc_fleet(root, cfg, device=dev)
    finally:
        if path0 is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = path0
    seconds = time.perf_counter() - t0
    print(f"fleet multiproc: returned in {seconds:.1f} s", file=sys.stderr,
          flush=True)
    blocked = os.path.join(site, "blocked.txt")
    check(not os.path.exists(blocked),
          "fleet multiproc: a worker imported jax or the JAX package")
    d = rep.to_dict()
    n = cfg.n_agents
    what = "fleet multiproc"
    check(d["published"] == cfg.processes * n * cfg.jobs_per_agent
          and d["failed"] == 0 and d["queue_counts"].get("queued", 0) == 0
          and d["queue_counts"].get("running", 0) == 0,
          f"{what}: published {d['published']}, failures "
          f"{dict(list(rep.failures.items())[:5])}, queue {d['queue_counts']}")
    check(d["restore_completed"] == cfg.restore_jobs
          and d["restore_failed"] == 0
          and d["verify_completed"] == cfg.verify_jobs
          and d["verify_failed"] == 0
          and d["sync_completed"] == cfg.sync_jobs and d["sync_failed"] == 0,
          f"{what}: lanes {d}")
    check(d["hostile_run"] == cfg.hostile_agents
          and d["hostile_liar_published"] == 0
          and d["hostile_liar_errors"] >= 1
          and "StreamLengthError" in " ".join(rep.hostile_liar_errors)
          and d["stream_length_violations"] >= 1 and d["evictions"] >= 1
          and d["reservations_reaped"] >= cfg.hostile_slowloris_rounds
          and not any(j.startswith("liar-") for j in rep.failures),
          f"{what}: hostiles {d}")
    check(rep.fair_order and fair_shares(
        rep.fair_order, 12, {"fp-heavy": 3, "fp-mid": 2, "fp-light": 1})
        and set(rep.fair_order) == {"fp-heavy", "fp-mid", "fp-light"}
        and sum(sum(g.values()) for g in d["tenant_grants"].values()) > 0,
        f"{what}: fair order {rep.fair_order}")
    check(all(0 < p99 <= 60.0 for p99 in d["enqueue_p99"].values()),
          f"{what}: enqueue p99 {d['enqueue_p99']}")
    check(d["written_once"] and d["cross_process_hits"] > 0
          and d["distinct_chunks_after"] > 0,
          f"{what}: written once {d['written_once']}, chunks "
          f"{d['chunks_written_total']} vs {d['distinct_chunks_after']} + "
          f"{d['chunks_removed_total']}, cross hits {d['cross_process_hits']}")
    check(d["gc_swept"] == d["gc_cycles"]
          and d["gc_held"] == d["gc_cycles"] * (cfg.processes - 1),
          f"{what}: GC outcomes {d['gc_outcomes']}")
    check(d["leader_killed"] and d["failover_outcome"] == "swept"
          and d["failover_s"] <= cfg.gc_ttl_s + 2.0
          and d["steals_total"] >= 1,
          f"{what}: failover {d['leader_killed']} {d['failover_outcome']} "
          f"{d['failover_s']} s, steals {d['steals_total']}")
    check(d["doomed_on_disk"] == 0 and d["doomed_resurrected"] == 0
          and d["live_missing"] == 0,
          f"{what}: doomed on disk {d['doomed_on_disk']}, resurrected "
          f"{d['doomed_resurrected']}, live missing {d['live_missing']}")
    check(d["deadline_rejects_seen"] >= 1
          and d["deadline_rejects_counted"] >= 1,
          f"{what}: deadline rejects {d['deadline_rejects_seen']}/"
          f"{d['deadline_rejects_counted']}")
    survivor = [p for p in d["service_lock_wait"] if p != d["leader_killed"]]
    check(len(survivor) == 1
          and d["service_lock_wait"][survivor[0]]["prune"]["count"] > 0
          and d["service_lock_wait"][survivor[0]]["jobqueue"]["count"] > 0,
          f"{what}: lock waits {d['service_lock_wait']}")
    launches = d["launches"]
    check(set(launches) == {"p0", "p1"} and (dev.type != "cuda" or (
          all(v > 0 for w in launches.values()
                  for k, v in w.items() if k != "cuckoo_probe")
          and sum(w["cuckoo_probe"] for w in launches.values()) > 0)),
          f"{what}: a kernel of a worker did not launch: {launches}")
    return {"seconds": seconds, "agents_per_worker": n,
            "published": d["published"],
            "published_mib": d["published"] * cfg.files_per_agent
            * cfg.file_size / 2**20,
            "worker_launches": launches, "gc_outcomes": d["gc_outcomes"],
            "workers": "pbs_plus_tpu_torch.server.fleetproc, jax and "
                       "pbs_plus_tpu blocked",
            "failover_s": d["failover_s"], "steals": d["steals_total"],
            "chunks_written": d["chunks_written_total"],
            "cross_process_hits": d["cross_process_hits"],
            "distinct_chunks_after": d["distinct_chunks_after"],
            "chunks_removed": d["chunks_removed_total"],
            "enqueue_p99_s": d["enqueue_p99"], "report": d}


def k2_chain_ms(length: int, clock_hz: float) -> float:
    """One message's K2 chain at the per-round floor: its 64-byte blocks
    (padding included) x 64 rounds x K2_ROUND_FLOOR_CYCLES."""
    return ((length + 8) // 64 + 1) * 64 * K2_ROUND_FLOOR_CYCLES / clock_hz * 1e3


def verification_phase(dev, stores: dict, clock_hz: float) -> dict:
    """The port's verification job over each store at a sample rate of 1.0
    on a minimal server shell: whole files re-hashed by K2 in the tpxd
    store (its entries carry file digests), chunks in 64 MiB batches in
    the pbs one; then one byte flipped in one payload chunk file of each."""
    from pbs_plus_tpu_torch.ops import sha256
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader
    from pbs_plus_tpu_torch.server.verification_job import (pick_snapshots,
                                                            run_verification)

    out = {"phase": "verification", "stores": {}}
    for kind, st in stores.items():
        ds = st.store.datastore
        srv = SimpleNamespace(config=SimpleNamespace(verify_workers=0),
                              datastore=SimpleNamespace(datastore=ds))
        v = {"id": "v-chip", "sample_rate": 1.0}
        picked = pick_snapshots(srv)
        sha256.KERNEL.launches = 0
        rep, secs = timed(lambda: asyncio.run(
            run_verification(srv, v, device=dev)))
        launches = sha256.KERNEL.launches
        check(rep["snapshots"] == [str(r) for r in picked]
              and rep["corrupt"] == [] and rep["drift"] == [],
              f"{kind} verification report: {rep}")
        check(launches > 0, f"K2 did not launch on the {kind} verification")
        # what the job hashed, and hashlib's time over the same bytes
        items = []
        if kind == "tpxd":
            for ref in picked:
                b = 0 if ref.backup_time == ds.list_snapshots(
                    "host", ref.backup_id)[0].backup_time else 1
                a = st.streams[b][ref.backup_id]
                items += [a[s:e] for s, e in st.files[ref.backup_id]
                          if e > s]
            lens = [len(x) for x in items]
            bound_ms = k2_chain_ms(max(lens), clock_hz)
            flushes = 1
        else:
            # the job's K2 batches: per snapshot, its distinct chunks in
            # waves of 8, flushed once 64 MiB are pending and at the end
            flushes, bound_ms = 0, 0.0
            for ref in picked:
                digs = []
                for idx in ds.load_indexes(ref):
                    digs += [idx.digest(i) for i in range(len(idx))]
                digs = list(dict.fromkeys(digs))
                pending, longest = 0, 0
                for w in range(0, len(digs), 8):
                    for d in digs[w:w + 8]:
                        items.append(ds.chunks.get(d))
                        pending += len(items[-1])
                        longest = max(longest, len(items[-1]))
                    if pending >= 64 << 20 or w + 8 >= len(digs):
                        flushes += 1
                        bound_ms += k2_chain_ms(longest, clock_hz)
                        pending = longest = 0
            lens = [len(x) for x in items]
        check(rep["checked"] == len(items),
              f"{kind} verification checked {rep['checked']}, want {len(items)}")
        t0 = time.perf_counter()
        for x in items:
            hashlib.sha256(x).digest()
        hashlib_s = time.perf_counter() - t0
        del items
        # one byte flipped in the middle of one payload chunk file of the
        # first picked snapshot
        ref = picked[0]
        pidx = ds.load_indexes(ref)[1]
        d = pidx.digest(len(pidx) // 2)
        with open(ds.chunks._path(d), "r+b") as f:
            raw = bytearray(f.read())
            raw[len(raw) // 2] ^= 0x40
            f.seek(0)
            f.write(raw)
        if kind == "pbs":
            rep2 = asyncio.run(run_verification(srv, v, device=dev))
            hit = [c for c in rep2["corrupt"] if c["snapshot"] == str(ref)]
            check(len(hit) == 1 and f"chunk:{d.hex()}" in hit[0]["files"],
                  f"pbs verification missed the flipped chunk: {rep2['corrupt']}")
            flipped = {"reported": hit[0]["files"]}
        else:
            # the reference's file-level path raises out of read_file
            try:
                asyncio.run(run_verification(srv, v, device=dev))
                raised = None
            except OSError as e:
                raised = str(e)
            check(raised is not None and "corrupt on disk" in raised
                  and d.hex() in raised,
                  f"tpxd verification did not raise on the flipped chunk: {raised}")
            flipped = {"raised": raised}
        # the byte flipped back: the mount phase mounts these snapshots
        with open(ds.chunks._path(d), "r+b") as f:
            raw[len(raw) // 2] ^= 0x40
            f.write(raw)
        out["stores"][kind] = {
            "snapshots": rep["snapshots"], "checked": rep["checked"],
            "bytes": sum(lens), "longest": max(lens), "seconds": secs,
            "hashlib_s": hashlib_s, "k2_launches": launches,
            "k2_flushes": flushes, "k2_bound_ms": bound_ms,
            "flipped_chunk": d.hex(), **flipped}
    return out


def sync_phase(dev, stores: dict, root: str) -> dict:
    """Datastore replication of the store phase's two stores, each into a
    fresh store on the card at the production ``sync_batch``: every tpxd
    snapshot pulled local to local, every pbs snapshot pulled over a
    ``SyncWireServer`` on loopback.  Checks: the chunks transferred are
    the source's distinct digests (their delta closure), every snapshot
    file and chunk file equals the source's, every transferred chunk
    re-hashes to its name through hashlib, the newest snapshot of each
    group reads back through ``SplitReader`` as its stream, K3 launches
    at the destination at least once a probe batch; a second run moves
    nothing and skips every snapshot; a run broken at
    ``pbsstore.sync.commit`` resumes with ``resumed: true`` and fewer
    chunks; ``pbsstore.sync.transfer=corrupt`` raises ``SyncError`` and
    leaves no chunk that does not verify."""
    import secrets

    from pbs_plus_tpu_torch.ops import cuckoo
    from pbs_plus_tpu_torch.pxar import syncwire as sw
    from pbs_plus_tpu_torch.pxar.datastore import Datastore
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader
    from pbs_plus_tpu_torch.utils import conf, failpoints

    t_phase = time.perf_counter()
    batch = conf.env().sync_batch
    check(batch == 1024, f"the production sync batch is 1024, not {batch}")
    token = secrets.token_hex(16)
    out = {"phase": "sync", "batch": batch, "stores": {}}

    def endpoints(kind, src, dst):
        """(source, dest, closers): tpxd local to local, pbs over HTTP."""
        if kind == "tpxd":
            return sw.LocalSyncSource(src), sw.LocalSyncDest(dst), []
        srv = sw.SyncWireServer(src, token)
        source = sw.HttpSyncSource(f"http://127.0.0.1:{srv.start()}", token)
        return source, sw.LocalSyncDest(dst), [source.close, srv.stop]

    def run(kind, src, dst, job, probe_ms=None):
        source, dest, closers = endpoints(kind, src, dst)
        if probe_ms is not None:
            inner = dest.probe_chunks

            def timed_probe(digests):
                t = time.perf_counter()
                present = inner(digests)
                probe_ms.append((time.perf_counter() - t) * 1e3)
                return present
            dest.probe_chunks = timed_probe
        try:
            t = time.perf_counter()
            stats = sw.run_sync(source, dest, job_id=job,
                                state_root=dst.base, batch=batch)
            return stats, time.perf_counter() - t
        finally:
            for close in closers:
                close()

    for kind, st in stores.items():
        src = st.store.datastore
        pbs = kind == "pbs"
        refs = src.list_snapshots()
        union = set()
        for ref in refs:
            for idx in src.load_indexes(ref):
                union.update(idx.digest(i) for i in range(len(idx)))
        distinct = src.chunks.delta_closure(union)
        dst = Datastore(os.path.join(root, f"sync-{kind}"), pbs_format=pbs,
                        device=dev)
        cuckoo.stats["device_probes"] = 0
        probe_ms = []
        stats, secs = run(kind, src, dst, f"chip-{kind}", probe_ms)
        k3 = cuckoo.stats["device_probes"]
        check(stats["snapshots_synced"] == len(refs)
              and stats["chunks_transferred"] == len(distinct),
              f"sync {kind}: {stats}, want {len(refs)} snapshots and "
              f"{len(distinct)} chunks")
        check(k3 >= stats["probe_batches"] > 0,
              f"sync {kind}: K3 launched {k3} times for "
              f"{stats['probe_batches']} probe batches")
        # the snapshot dirs and the chunk files, byte for byte
        for ref in refs:
            a, b = src.snapshot_dir(ref), dst.snapshot_dir(ref)
            names = sorted(os.listdir(a))
            check(sorted(os.listdir(b)) == names, f"sync {kind} {ref}: files")
            for n in names:
                with open(os.path.join(a, n), "rb") as fa, \
                        open(os.path.join(b, n), "rb") as fb:
                    check(fa.read() == fb.read(), f"sync {kind} {ref}/{n}")
        stored = sorted(dst.chunks.iter_digests())
        check(set(stored) == distinct, f"sync {kind}: the mirror's chunks")

        def same_and_hashes(d):
            return dst.chunks.get_raw(d) == src.chunks.get_raw(d) and \
                hashlib.sha256(dst.chunks.get(d)).digest() == d

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            ok = list(pool.map(same_and_hashes, stored))
        rehash_s = time.perf_counter() - t0
        check(all(ok), f"sync {kind}: a chunk differs or does not hash")
        # the newest snapshot of each group, read back as its stream
        t0 = time.perf_counter()
        read = 0
        for n in st.groups:
            ref = dst.last_snapshot("host", n)
            rd = SplitReader.open_snapshot(dst, ref)
            a = st.streams[1][n]
            for e, (s, t) in zip([e for e in rd.entries() if e.is_file],
                                 st.files[n]):
                got = rd.read_file(e)
                check(np.array_equal(np.frombuffer(got, np.uint8), a[s:t]),
                      f"sync {kind} {ref} {e.path} does not read back")
                read += len(got)
        read_s = time.perf_counter() - t0
        # again: nothing to move
        cuckoo.stats["device_probes"] = 0
        again, again_s = run(kind, src, dst, f"chip-{kind}")
        check(again["chunks_transferred"] == 0 and again["bytes_wire"] == 0
              and again["snapshots_skipped"] == len(refs),
              f"sync {kind} second run: {again}")
        # broken at the second snapshot's publish, then resumed
        dst2 = Datastore(os.path.join(root, f"sync-{kind}-resume"),
                         pbs_format=pbs, device=dev)
        with failpoints.armed("pbsstore.sync.commit", "raise", nth=2):
            try:
                run(kind, src, dst2, "chip-resume")
                broke = None
            except sw.SyncError as e:
                broke = str(e)
        check(broke is not None and len(dst2.list_snapshots()) == 1,
              f"sync {kind}: the commit fault did not break the run: {broke}")
        resumed, resumed_s = run(kind, src, dst2, "chip-resume")
        check(resumed["resumed"] is True
              and resumed["chunks_transferred"] < stats["chunks_transferred"]
              and resumed["snapshots_synced"] == len(refs) - 1,
              f"sync {kind} resumed run: {resumed}")
        shutil.rmtree(dst2.base, ignore_errors=True)
        # a payload corrupted on the wire: typed failure, no torn chunk
        dst3 = Datastore(os.path.join(root, f"sync-{kind}-corrupt"),
                         pbs_format=pbs, device=dev)
        with failpoints.armed("pbsstore.sync.transfer", "corrupt", nth=7):
            try:
                run(kind, src, dst3, "chip-corrupt")
                corrupt = None
            except sw.SyncError as e:
                corrupt = str(e)
        landed = list(dst3.chunks.iter_digests())
        check(corrupt is not None and dst3.list_snapshots() == []
              and all(hashlib.sha256(dst3.chunks.get(d)).digest() == d
                      for d in landed),
              f"sync {kind}: the corrupt payload: {corrupt}, "
              f"{len(landed)} chunks landed")
        check(not [f for dp, _dn, fn in os.walk(dst3.base) for f in fn
                   if ".tmp" in f], f"sync {kind}: .tmp debris")
        shutil.rmtree(dst3.base, ignore_errors=True)
        out["stores"][kind] = {
            "wire": "local" if kind == "tpxd" else "http",
            "snapshots": len(refs), "seconds": secs,
            "logical_mib_s": stats["bytes_logical"] / 2**20 / secs,
            "wire_mib_s": stats["bytes_wire"] / 2**20 / secs,
            "stats": stats, "k3_launches": k3,
            "probe_ms_per_batch": pct(probe_ms), "rehash_s": rehash_s,
            "read_back_bytes": read, "read_back_s": read_s,
            "rerun_s": again_s, "resumed": {
                "broken": broke, "chunks": resumed["chunks_transferred"],
                "seconds": resumed_s},
            "corrupt": {"raised": corrupt, "chunks_landed": len(landed)}}
        shutil.rmtree(dst.base, ignore_errors=True)
    out["launches"] = {"cuckoo_probe": sum(
        s["k3_launches"] for s in out["stores"].values())}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def verify_batches(entries: list[tuple[str, int]], ceiling: int):
    """What ``CommitEngine._verify_entries`` does with ``entries`` (path,
    size) in order: the files over ``ceiling`` hashed on the host, the
    rest in batches flushed once they hold ``ceiling`` bytes."""
    host, batches, batch, held = [], [], [], 0
    for path, size in entries:
        if size > ceiling:
            host.append((path, size))
            continue
        batch.append((path, size))
        held += size
        if held >= ceiling:
            batches.append(batch)
            batch, held = [], 0
    if batch:
        batches.append(batch)
    return host, batches


def mount_phase(dev, stores: dict, seed: int, root: str, clock_hz: float) -> dict:
    """One mount per layout of the store phase's newest snapshot of its
    first group (256 MiB of files), driven through ``MutableFS`` calls and
    committed by ``CommitEngine(device=dev)``: 4 KiB writes into
    MOUNT_WRITES files, the largest file overwritten whole past the
    verify's batch ceiling (so the host-hash branch runs), MOUNT_NEW_FILES
    new files in a new directory, MOUNT_UNLINKS unlinks and the rename of
    the directory of every archived file; commit #1, two more 4 KiB
    writes and commit #2, then one write and commit #3 through an engine
    that flips one bit of one expected digest before the verify.  Every
    file of commits #1 and #2 read back through ``SplitReader`` equals a
    host dict of the mutations; the changed files' digests equal
    hashlib's; commit #3 raises and publishes nothing."""
    from pbs_plus_tpu_torch.mount import (ArchiveView, CommitEngine, Journal,
                                          MutableFS)
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar import chunkcache
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader

    class MeasuredEngine(CommitEngine):
        def _verify_entries(self, vp, reader, entries):
            self.verified_entries = [(e.path, e.size) for e in entries]
            return super()._verify_entries(vp, reader, entries)

    class FlippingEngine(CommitEngine):
        def _verify_entries(self, vp, reader, entries):
            e = entries[0]
            e.digest = bytes([e.digest[0] ^ 1]) + e.digest[1:]
            return super()._verify_entries(vp, reader, entries)

    out = {"phase": "mount", "layouts": {}}
    totals = {"candidate_mask": 0, "sha256_chunks": 0, "cuckoo_probe": 0}
    for kind, st in stores.items():
        name = st.groups[0]
        ls, ds = st.store, st.store.datastore
        ref0 = ds.last_snapshot("host", name)
        a = st.streams[1][name]
        host = {f"d/f{i:05d}": a[s:e].tobytes()
                for i, (s, e) in enumerate(st.files[name])}
        mroot = os.path.join(root, f"mount-{kind}")
        fs = MutableFS(ArchiveView(ls.open_snapshot(
            ref0, cache=chunkcache.shared_cache())),
            Journal(os.path.join(mroot, "journal.db")),
            os.path.join(mroot, "passthrough"))
        engine = MeasuredEngine(fs, ls, backup_id=name, previous=ref0,
                                device=dev)
        if MOUNT_VERIFY_BATCH:
            engine.VERIFY_BATCH_BYTES = MOUNT_VERIFY_BATCH
        ceiling = engine.VERIFY_BATCH_BYTES
        marks = []
        engine.progress.listeners.append(
            lambda ph, info: marks.append((ph, time.perf_counter())))

        # the mutations, the same draws for both layouts
        rng = np.random.default_rng(seed + 300)
        paths = sorted(host)
        big = max(paths, key=lambda p: len(host[p]))
        others = [p for p in paths
                  if p != big and len(host[p]) >= MOUNT_WRITE_BYTES]
        pick = [others[i] for i in rng.permutation(len(others))]
        written = pick[:MOUNT_WRITES]
        unlinked = pick[MOUNT_WRITES:MOUNT_WRITES + MOUNT_UNLINKS]
        check(len(unlinked) == MOUNT_UNLINKS,
              f"{kind}: {len(others)} files too few for the mutations")

        def write(path, off=None):
            if off is None:
                off = int(rng.integers(0, len(host[path]) - MOUNT_WRITE_BYTES + 1))
            data = rng.bytes(MOUNT_WRITE_BYTES)
            fs.write(path, data, off)
            host[path] = host[path][:off] + data + host[path][off + len(data):]
            return off, data

        for p in written:
            write(p)
        data = rng.bytes(max(len(host[big]), ceiling + ceiling // 4))
        fs.write(big, data, 0)
        host[big] = data
        fs.mkdir("n")
        lo, hi = np.log(STORE_FILE_MIN), np.log(MOUNT_NEW_MAX)
        for i in range(MOUNT_NEW_FILES):
            data = rng.bytes(int(np.exp(rng.uniform(lo, hi))))
            fs.create(f"n/new{i:02d}")
            fs.write(f"n/new{i:02d}", data)
            host[f"n/new{i:02d}"] = data
        for p in unlinked:
            fs.unlink(p)
            del host[p]
        fs.rename("d", "r")
        host = {("r" + p[1:] if p.startswith("d/") else p): v
                for p, v in host.items()}
        untouched = len(paths) - MOUNT_WRITES - 1 - MOUNT_UNLINKS

        def commit(tag):
            marks.clear()
            gen = fs.view.generation
            prog = engine.progress
            ref_files0 = prog.ref_files
            rolling_hash.KERNEL.launches = 0
            sha256.KERNEL.launches = 0
            cuckoo.stats["device_probes"] = 0
            ref, secs = timed(engine.commit)
            launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                        "sha256_chunks": sha256.KERNEL.launches,
                        "cuckoo_probe": cuckoo.stats["device_probes"]}
            for k, v in launches.items():
                totals[k] += v
            check(fs.view.generation == gen + 1,
                  f"{kind} {tag}: generation {fs.view.generation} after {gen}")
            js = fs.journal.stats()
            check(js["edges"] == js["whiteouts"] == js["xattrs"] == 0,
                  f"{kind} {tag}: journal not empty after the commit: {js}")
            check(os.listdir(fs.passthrough) == [],
                  f"{kind} {tag}: passthrough directory not empty")
            # every file reads back; every changed file's digest is hashlib's
            rd = SplitReader.open_snapshot(ds, ref)
            ents = {e.path: e for e in rd.entries() if e.is_file}
            check(sorted(ents) == sorted(host), f"{kind} {tag}: file list")
            for p, e in ents.items():
                check(rd.read_file(e) == host[p], f"{kind} {tag}: {p} differs")
            changed = list(engine._changed_paths)
            for p in changed:
                d = hashlib.sha256(host[p]).digest()
                check(engine._changed_digests[p] == d and (
                    kind == "pbs" or ents[p].digest == d),
                    f"{kind} {tag}: digest of {p} != hashlib")
            nonempty = sum(1 for p in changed if host[p])
            check(prog.verified == nonempty,
                  f"{kind} {tag}: verified {prog.verified}, want {nonempty}")
            man = ds.load_manifest(ref)
            check(man["stats"]["ref_chunks"] > 0,
                  f"{kind} {tag}: no chunk reused by reference")
            # what the verify hashed, and where
            host_hashed, batches = verify_batches(engine.verified_entries,
                                                  ceiling)
            t0 = time.perf_counter()
            for p, _ in engine.verified_entries:
                hashlib.sha256(host[p]).digest()
            hashlib_s = time.perf_counter() - t0
            ts = dict(marks)
            order = [ph for ph, _ in marks]
            changed_bytes = sum(len(host[p]) for p in changed)
            return ref, {
                "snapshot": str(ref), "seconds": secs,
                "phase_seconds": {ph: ts[order[i + 1]] - ts[ph]
                                  for i, ph in enumerate(order[:-1])},
                "changed_files": len(changed), "changed_bytes": changed_bytes,
                "changed_mib_s": changed_bytes / 2**20 / secs,
                "ref_files": prog.ref_files - ref_files0,
                "untouched_files": untouched if tag == "commit1" else None,
                "new_chunks": man["stats"]["new_chunks"],
                "known_chunks": man["stats"]["known_chunks"],
                "ref_chunks": man["stats"]["ref_chunks"],
                "launches": launches, "verified": prog.verified,
                "verify": {"k2_files": sum(len(b) for b in batches),
                           "k2_bytes": sum(n for b in batches for _, n in b),
                           "k2_batches": len(batches),
                           "host_files": len(host_hashed),
                           "host_bytes": sum(n for _, n in host_hashed),
                           "hashlib_s": hashlib_s,
                           "k2_bound_ms": sum(k2_chain_ms(max(n for _, n in b),
                                                          clock_hz)
                                              for b in batches)}}

        ref1, c1 = commit("commit1")
        check(all(v > 0 for v in c1["launches"].values()),
              f"a kernel of the {kind} commit path did not launch: "
              f"{c1['launches']}")
        check(c1["ref_files"] >= untouched,
              f"{kind}: {c1['ref_files']} files by reference, "
              f"{untouched} untouched")
        check(c1["verify"]["host_files"] >= 1 and c1["verify"]["k2_files"] >= 1,
              f"{kind}: the verify did not split host/K2: {c1['verify']}")
        live = [p for p in sorted(host) if p.startswith("r/")
                and len(host[p]) >= MOUNT_WRITE_BYTES]
        for i in rng.permutation(len(live))[:2]:
            write(live[i])
        ref2, c2 = commit("commit2")
        # commit #3: one write, then a verify that must fail on K2's verdict
        snaps = [str(r) for r in ds.list_snapshots("host", name)]
        gen = fs.view.generation
        p3 = live[0]
        off, data = write(p3)
        bad = FlippingEngine(fs, ls, backup_id=name, previous=ref2, device=dev)
        if MOUNT_VERIFY_BATCH:
            bad.VERIFY_BATCH_BYTES = MOUNT_VERIFY_BATCH
        try:
            bad.commit()
            raised = None
        except RuntimeError as e:
            raised = str(e)
        check(raised == "commit verification failed for 1 files",
              f"{kind} commit #3 did not fail its verify: {raised}")
        check([str(r) for r in ds.list_snapshots("host", name)] == snaps,
              f"{kind} commit #3 published a snapshot")
        check(fs.view.generation == gen and fs.journal.stats()["edges"] > 0
              and fs.read(p3, off, len(data)) == data,
              f"{kind} commit #3 did not leave the mount as it was")
        fs.journal.close()
        out["layouts"][kind] = {"group": name, "mounted": str(ref0),
                                "files": len(paths), "bytes": len(a),
                                "verify_ceiling": ceiling,
                                "commits": [c1, c2],
                                "failing_commit": raised}
    out["launches"] = totals
    return out


def backup_job_phase(dev, P, streams: dict, seed: int, root: str) -> dict:
    """The agent backup job on the card, end to end through the port's
    entry points: the 8 streams written to disk as 8 agent trees (files
    cut as in the store phase under ``d/``, a symlink, a hard link and a
    ``*.tmp`` file the job row excludes), a port ``Database`` with 8
    agent targets and 8 job rows, an ``AgentsManager`` and ``serve`` on
    loopback (mTLS with the port's ``CertManager`` where ``cryptography``
    imports, else the plain loopback mode), 8 port ``AgentLifecycle``s on
    an event loop of their own, and two ``LocalStore(device=dev)`` at the
    production defaults: jobs 0-3 into a tpxd store, 4-7 into a pbs one.
    Backup #1 runs the 8 jobs at once through ``run_target_backup``;
    backup #2 after the store phase's 4 writes of 4 KiB a stream; then a
    job of tree 0 severed by ``backup.file.stream=drop@nth=N`` partway,
    retried once from its checkpoint, and a local-target job of tree 0.
    Every file of every snapshot reads back equal to its source, every
    stored chunk re-hashes equal under hashlib, new/known counts hold
    against the indexes, the excluded file is absent and the hard link
    is stored once; the severed job's and the local job's files equal
    backup #2's of the same tree; K1, K2 and K3 launch under the jobs."""
    from pbs_plus_tpu_torch.agent import agentfs, snapshots
    from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
    from pbs_plus_tpu_torch.arpc import (AgentsManager, Router, TlsClientConfig,
                                         TlsServerConfig, serve)
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader
    from pbs_plus_tpu_torch.server import backup_job, database
    from pbs_plus_tpu_torch.utils import failpoints, trace

    names = sorted(streams)
    half = len(names) // 2
    files = {n: store_files(STREAM_BYTES, seed + 100 + k)
             for k, n in enumerate(names)}
    streams2 = rewrite(streams, seed)
    trees = {n: os.path.join(root, "agents", n) for n in names}

    def write_tree(n, strs):
        """Tree ``n`` as ``strs[n]`` cut into its files; a file rewritten
        only where its bytes changed (backup #2's writes)."""
        d = os.path.join(trees[n], "d")
        os.makedirs(d, exist_ok=True)
        for i, (s, e) in enumerate(files[n]):
            p = os.path.join(d, f"f{i:05d}")
            if strs is streams or not np.array_equal(streams[n][s:e],
                                                     strs[n][s:e]):
                strs[n][s:e].tofile(p)
        if strs is streams:
            os.symlink("d/f00000", os.path.join(trees[n], "ln"))
            os.link(os.path.join(d, "f00001"), os.path.join(trees[n], "hard"))
            with open(os.path.join(trees[n], "skip.tmp"), "wb") as f:
                f.write(b"excluded by the job row" * 100)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda n: write_tree(n, streams), names))
    write_s = time.perf_counter() - t0

    # the transport: mTLS where the wheel imports, else plain loopback
    try:
        import cryptography  # noqa: F401
        from pbs_plus_tpu_torch.utils import mtls
        transport = "mtls"
    except ImportError:
        transport = "loopback-plain"
    server_tls, agent_tls = None, {n: None for n in names}
    if transport == "mtls":
        cm = mtls.CertManager(os.path.join(root, "certs"))
        cm.load_or_create_ca()
        cm.ensure_server_identity("pbs-server")
        server_tls = TlsServerConfig(cm.server_cert_path, cm.server_key_path,
                                     cm.ca_cert_path)
        for n in names:
            cert, key = cm.issue(n)
            for ext, blob in (("pem", cert), ("key", key)):
                with open(os.path.join(root, "certs", f"{n}.{ext}"), "wb") as f:
                    f.write(blob)
            agent_tls[n] = TlsClientConfig(
                os.path.join(root, "certs", f"{n}.pem"),
                os.path.join(root, "certs", f"{n}.key"), cm.ca_cert_path)

    db = database.Database(os.path.join(root, "server.db"))
    for k, n in enumerate(names):
        db.upsert_target(n, "agent", hostname=n)
        db.upsert_backup_job(database.BackupJobRow(
            id=f"job-{k}", target=n, source_path=trees[n], backup_id=n,
            exclusions=["*.tmp"]))
    db.upsert_backup_job(database.BackupJobRow(
        id="job-severed", target=names[0], source_path=trees[names[0]],
        backup_id=f"{names[0]}-severed", exclusions=["*.tmp"]))
    db.upsert_target("local-0", "local", root_path=trees[names[0]])
    db.upsert_backup_job(database.BackupJobRow(
        id="job-local", target="local-0", source_path=trees[names[0]],
        backup_id=f"{names[0]}-local", exclusions=["*.tmp"]))
    stores = {kind: LocalStore(os.path.join(root, kind), P,
                               pbs_format=kind == "pbs", device=dev)
              for kind in ("tpxd", "pbs")}
    store_of = {n: stores["tpxd" if k < half else "pbs"]
                for k, n in enumerate(names)}

    # the job's seconds by layer: the agent's read_at (pread) and its raw
    # stream send, the writer thread's time not spent waiting on the pump
    # (chunking, K2 flushes, the probe, the chunk writes), the publish
    lock = threading.Lock()
    agent_s = {"read_at": 0.0, "send": 0.0, "reads": 0}
    writer_s = {}
    tl = threading.local()
    orig_read_at = agentfs.AgentFSServer._read_at
    orig_body = backup_job.RemoteTreeBackup._writer_loop_body
    orig_get = backup_job._get_abortable
    orig_snapshots = snapshots.SnapshotManager

    async def read_at(self, req, ctx):
        t = time.perf_counter()
        out = await orig_read_at(self, req, ctx)
        t1 = time.perf_counter()
        fn = out.fn

        async def send(stream):
            t2 = time.perf_counter()
            try:
                await fn(stream)
            finally:
                with lock:
                    agent_s["send"] += time.perf_counter() - t2
        out.fn = send
        with lock:
            agent_s["read_at"] += t1 - t
            agent_s["reads"] += 1
        return out

    def writer_body(self):
        tl.wait = 0.0
        t = time.perf_counter()
        try:
            return orig_body(self)
        finally:
            with lock:
                writer_s[self.session.ref.backup_id] = (
                    time.perf_counter() - t, tl.wait)

    def get_abortable(q, abort):
        # every wait of the writer thread on the pump: the entry queue
        # and each file's block queue
        t = time.perf_counter()
        try:
            return orig_get(q, abort)
        finally:
            if hasattr(tl, "wait"):
                tl.wait += time.perf_counter() - t

    class DirectSnapshots(orig_snapshots):
        """No filesystem is frozen or snapshotted here: the trees are
        read live."""
        def __init__(self, **kw):
            super().__init__(prefer_direct=True, **kw)

    agentfs.AgentFSServer._read_at = read_at
    backup_job.RemoteTreeBackup._writer_loop_body = writer_body
    backup_job._get_abortable = get_abortable
    snapshots.SnapshotManager = DirectSnapshots

    # the agents' own event loop, as on their own hosts
    agent_loop = asyncio.new_event_loop()
    agent_thread = threading.Thread(target=agent_loop.run_forever,
                                    name="agents", daemon=True)
    agent_thread.start()
    loop = asyncio.new_event_loop()
    agents = AgentsManager()

    async def on_connection(conn, peer, headers):
        # as the server's aRPC listener does: a control session serves
        # the server's router, a job data session an empty one (the
        # server is the client there)
        sess = await agents.register(peer, headers, conn)
        try:
            await Router().serve_connection(conn, context=sess)
        finally:
            await agents.unregister(sess)

    listener = loop.run_until_complete(serve(
        "127.0.0.1", 0, server_tls, on_connection=on_connection,
        admit=agents.admit))
    port = listener.sockets[0].getsockname()[1]
    lifecycles = {n: AgentLifecycle(
        AgentConfig(hostname=n, server_host="127.0.0.1", server_port=port,
                    tls=agent_tls[n], job_isolation="task",
                    drive_update_interval_s=0),
        snapshot_manager=DirectSnapshots()) for n in names}
    for lc in lifecycles.values():
        asyncio.run_coroutine_threadsafe(lc.run(), agent_loop)

    async def shutdown():
        # the agents stop on their loop while the server's runs, so each
        # side sees the other's close
        try:
            await asyncio.wait_for(asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(
                    stop_lifecycles(lifecycles.values()), agent_loop)), 60)
        finally:
            await stop_server()

    async def stop_server():
        listener.close()
        try:
            await asyncio.wait_for(listener.wait_closed(), 15)
        except asyncio.TimeoutError:
            pass
        for t in asyncio.all_tasks():
            if t is not asyncio.current_task():
                t.cancel()
        await asyncio.gather(*(t for t in asyncio.all_tasks()
                               if t is not asyncio.current_task()),
                             return_exceptions=True)

    async def registered():
        for n in names:
            await agents.wait_session(n, timeout=60)

    def jobs(rows, **kw):
        """The rows' jobs at once; per job its result (or exception) and
        seconds, the wall seconds, the launches and the publish
        seconds."""
        async def one(row):
            t = time.perf_counter()
            try:
                res = await backup_job.run_target_backup(
                    row, db=db, agents=agents,
                    store=store_of.get(row.target, stores["tpxd"]), **kw)
            except Exception as e:
                res = e
            return res, time.perf_counter() - t

        async def all_rows():
            return await asyncio.gather(*(one(r) for r in rows))

        rolling_hash.KERNEL.launches = 0
        sha256.KERNEL.launches = 0
        cuckoo.stats["device_probes"] = 0
        pubs = []

        def on_close(rec):
            # the publish span feeds no histogram: its closes are read here
            if rec["name"] == "backup.publish":
                pubs.append(rec["dur_s"])
        trace.subscribe(on_close)
        t = time.perf_counter()
        try:
            got = loop.run_until_complete(all_rows())
        finally:
            trace.unsubscribe(on_close)
        wall = time.perf_counter() - t
        launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                    "sha256_chunks": sha256.KERNEL.launches,
                    "cuckoo_probe": cuckoo.stats["device_probes"]}
        return got, wall, launches, (sum(pubs), len(pubs))

    out = {"phase": "backup_job", "transport": transport,
           "params": [P.avg_size, P.min_size, P.max_size],
           "tree_bytes": STREAM_BYTES, "trees_written_s": write_s,
           "files": {n: len(files[n]) for n in names},
           "read_block": backup_job.READ_BLOCK,
           "queue_depth": backup_job.QUEUE_DEPTH, "backups": []}
    seen = {kind: set() for kind in stores}
    try:
        loop.run_until_complete(registered())
        rows = [db.get_backup_job(f"job-{k}") for k in range(len(names))]
        results = []
        for b, strs in enumerate((streams, streams2)):
            if b:
                with ThreadPoolExecutor(8) as pool:
                    list(pool.map(lambda n: write_tree(n, streams2), names))
            for key in agent_s:
                agent_s[key] = 0
            writer_s.clear()
            got, wall, launches, (pub_s, pub_n) = jobs(rows)
            errs = [f"{r.id}: {res!r}" for r, (res, _) in zip(rows, got)
                    if isinstance(res, Exception)]
            check(not errs, f"backup job #{b + 1} failed: {errs}")
            check(all(res.errors == [] for res, _ in got),
                  f"backup job #{b + 1} errors: {[res.errors for res, _ in got]}")
            check(all(v > 0 for v in launches.values()),
                  f"a kernel of the backup job did not launch in #{b + 1}: "
                  f"{launches}")
            per_store = {}
            for kind, ls in stores.items():
                ds = ls.datastore
                mine = [(n, res, secs) for n, (res, secs) in zip(names, got)
                        if store_of[n] is ls]
                digs = set()
                for n, res, _ in mine:
                    ref = ds.last_snapshot("host", n)
                    check(str(ref) == res.snapshot,
                          f"{kind} {n}: result snapshot {res.snapshot}")
                    for idx in ds.load_indexes(ref):
                        digs.update(idx.digest(i) for i in range(len(idx)))
                stats = [res.manifest["stats"] for _, res, _ in mine]
                new = sum(st["new_chunks"] for st in stats)
                known = sum(st["known_chunks"] for st in stats)
                reused = sum(st["ref_chunks"] for st in stats)
                chunks = sum(res.manifest["meta_chunks"]
                             + res.manifest["payload_chunks"]
                             for _, res, _ in mine)
                check(new == len(digs - seen[kind])
                      and new + known + reused == chunks,
                      f"{kind} job backup #{b + 1}: new {new}, known {known}, "
                      f"reused {reused}, chunks {chunks}, novel digests "
                      f"{len(digs - seen[kind])}")
                if b:
                    check(known > 0 and new < chunks // 2,
                          f"{kind} job backup #2 did not find the unchanged "
                          f"chunks known: new {new}, known {known}")
                seen[kind] |= digs
                longest = max(secs for _, _, secs in mine)
                per_store[kind] = {
                    "groups": [n for n, _, _ in mine],
                    "mib_s": len(mine) * STREAM_BYTES / 2**20 / longest,
                    "new_chunks": new, "known_chunks": known,
                    "reused_chunks": reused, "chunks": chunks,
                    "bytes_on_disk": dir_bytes(ls.datastore.base)}
            per_job = {}
            for n, (res, secs) in zip(names, got):
                w_total, w_wait = writer_s.get(n, (0.0, 0.0))
                check(res.bytes_total == STREAM_BYTES
                      and res.files == len(files[n]),
                      f"job {n} #{b + 1}: {res.files} files, "
                      f"{res.bytes_total} bytes")
                per_job[n] = {"seconds": secs,
                              "mib_s": STREAM_BYTES / 2**20 / secs,
                              "writer_s": w_total,
                              "writer_busy_s": w_total - w_wait,
                              "writer_wait_s": w_wait}
            out["backups"].append({
                "backup": b + 1, "wall_s": wall,
                "mib_s": len(names) * STREAM_BYTES / 2**20 / wall,
                "launches": launches, "stores": per_store, "jobs": per_job,
                "agent_read_at_s": agent_s["read_at"],
                "agent_send_s": agent_s["send"],
                "agent_reads": agent_s["reads"],
                "publish_s": pub_s, "publishes": pub_n})
            results.append(dict(zip(names, (res for res, _ in got))))

        # a severed job: tree 0's stream dropped partway, the retry
        # resumes from its last checkpoint and publishes
        n0 = names[0]
        hits = sum(-(-(e - s) // backup_job.READ_BLOCK) + 1
                   for s, e in files[n0])
        nth = max(2, int(hits * JOB_SEVER_AT))
        failed = []
        orig_job = backup_job.run_backup_job

        async def spied(*a, **kw):
            try:
                return await orig_job(*a, **kw)
            except Exception as e:
                failed.append(f"{type(e).__name__}: {e}")
                raise

        backup_job.run_backup_job = spied
        try:
            fps = failpoints.arm_from_spec(f"backup.file.stream=drop@nth={nth}")
            got, wall, launches, (pub_s, _) = jobs(
                [db.get_backup_job("job-severed")], attempts=2,
                checkpoint_interval=JOB_CHECKPOINT)
        finally:
            failpoints.disarm("backup.file.stream")
            backup_job.run_backup_job = orig_job
        sev, sev_s = got[0]
        check(not isinstance(sev, Exception), f"severed job failed: {sev!r}")
        check(fps[0].fires == 1 and len(failed) == 1
              and "injected connection drop" in failed[0],
              f"the severed job's first attempt: {failed}")
        resume = sev.manifest.get("resume")
        check(resume is not None and resume["files_skipped"] > 0
              and 0 < resume["bytes_reread"] < STREAM_BYTES,
              f"the severed job did not resume from a checkpoint: {resume}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the severed job did not launch: {launches}")
        out["severed"] = {"nth": nth, "read_hits": hits,
                          "first_attempt": failed[0], "seconds": sev_s,
                          "resume": resume,
                          "reread_share": resume["bytes_reread"] / STREAM_BYTES,
                          "launches": launches,
                          "stats": sev.manifest["stats"]}

        # a local target over tree 0
        got, wall, launches, _ = jobs([db.get_backup_job("job-local")])
        loc, loc_s = got[0]
        check(not isinstance(loc, Exception) and loc.errors == [],
              f"local job failed: {loc!r}")
        out["local"] = {"seconds": loc_s,
                        "mib_s": STREAM_BYTES / 2**20 / loc_s,
                        "launches": launches, "stats": loc.manifest["stats"]}
    finally:
        loop.run_until_complete(shutdown())
        agent_loop.call_soon_threadsafe(agent_loop.stop)
        agent_thread.join(30)
        agent_loop.close()
        loop.close()
        agentfs.AgentFSServer._read_at = orig_read_at
        backup_job.RemoteTreeBackup._writer_loop_body = orig_body
        backup_job._get_abortable = orig_get
        snapshots.SnapshotManager = orig_snapshots
        db.close()

    # every file of every snapshot reads back as its source
    t0 = time.perf_counter()
    read = 0

    def snapshot_files(ls, ref):
        rd = SplitReader.open_snapshot(ls.datastore, ref)
        by = {e.path: e for e in rd.entries()}
        return rd, by

    want_paths = [f"d/f{i:05d}" for i in range(max(len(v) for v in files.values()))]
    for b, strs in enumerate((streams, streams2)):
        for n in names:
            ls = store_of[n]
            rd, by = snapshot_files(ls, ls.datastore.list_snapshots("host", n)[b])
            check("skip.tmp" not in by, f"{n} #{b + 1}: the excluded file was stored")
            check(by["hard"].kind == "h" and by["hard"].link_target == "d/f00001"
                  and by["ln"].link_target == "d/f00000",
                  f"{n} #{b + 1}: the hard link or symlink")
            ents = [e for e in rd.entries() if e.is_file]
            check([e.path for e in ents] == want_paths[:len(files[n])],
                  f"{n} #{b + 1}: entries")
            for e, (s, t) in zip(ents, files[n]):
                got_b = rd.read_file(e)
                check(np.array_equal(np.frombuffer(got_b, np.uint8),
                                     strs[n][s:t]),
                      f"{n} #{b + 1}: {e.path} does not read back")
                read += len(got_b)
    # the severed and the local job: backup #2's files of tree 0
    ls0 = stores["tpxd"]
    rd2, by2 = snapshot_files(ls0, ls0.datastore.last_snapshot("host", names[0]))
    want = {p: rd2.read_file(e) for p, e in by2.items() if e.is_file}
    for tag in ("severed", "local"):
        rd, by = snapshot_files(ls0, ls0.datastore.last_snapshot(
            "host", f"{names[0]}-{tag}"))
        check({p: (e.kind, e.link_target) for p, e in by.items()} ==
              {p: (e.kind, e.link_target) for p, e in by2.items()},
              f"the {tag} job's entries differ from backup #2's")
        got_files = {p: rd.read_file(e) for p, e in by.items() if e.is_file}
        check(got_files == want, f"the {tag} job's files differ from backup #2's")
        read += sum(len(v) for v in got_files.values())
    del want
    read_s = time.perf_counter() - t0

    # every stored chunk, decompressed, hashes to its name
    t0 = time.perf_counter()
    for kind, ls in stores.items():
        ds = ls.datastore
        stored = list(ds.chunks.iter_digests())
        with ThreadPoolExecutor(8) as pool:
            ok = list(pool.map(
                lambda d: hashlib.sha256(ds.chunks.get(d)).digest() == d, stored))
        check(all(ok) and seen[kind] <= set(stored),
              f"{kind}: stored chunks != hashlib or missing indexed chunks")
        out.setdefault("stored_chunks", {})[kind] = len(stored)
    out["read_back_bytes"] = read
    out["read_back_s"] = read_s
    out["rehash_s"] = time.perf_counter() - t0
    out["launches"] = {k: sum(r["launches"][k] for r in out["backups"])
                       + out["severed"]["launches"][k]
                       + out["local"]["launches"][k]
                       for k in out["backups"][0]["launches"]}
    return out


def _tail(path: str, n: int = 6000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"({e})"


def _read_line(proc, pred, timeout: float) -> list[str]:
    """stdout lines of ``proc`` up to the first that satisfies ``pred``.
    A thread reads them: a select on the pipe would miss lines that the
    text stream's buffer already holds."""
    import queue
    lines_q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines_q.put(line.rstrip("\n"))
        lines_q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    lines, t_end = [], time.monotonic() + timeout
    while True:
        left = t_end - time.monotonic()
        check(left > 0, f"web: no expected line from {proc.args[3]} in "
                        f"{timeout} s: {lines}")
        try:
            line = lines_q.get(timeout=min(left, 0.5))
        except queue.Empty:
            check(proc.poll() is None,
                  f"web: {proc.args[3]} exited with {proc.returncode}")
            continue
        check(line is not None, f"web: {proc.args[3]} closed its stdout")
        lines.append(line)
        if pred(line):
            return lines


def _children(pid: int) -> list[int]:
    """Processes whose parent is ``pid`` (read from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def _stop(procs: list, extra: set) -> None:
    """SIGINT (the commands stop their server/agent on it), then SIGKILL
    whatever is left, the agent's job children included."""
    import signal
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)
    for pid in extra:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def web_phase(seed: int, root: str, sync_peer: str = "") -> dict:
    """The port as its users run it: ``python -m pbs_plus_tpu_torch
    server --device <card> --print-token`` and ``... agent`` (jobs in
    ``agent-job`` children) as two processes, the agent enrolled over
    ``POST /plus/agent/bootstrap`` with the printed token, and every step
    through the HTTP API with the printed API token: a target and a
    backup job (chunker left to the server's default), backup #1 of a
    512 MiB tree, the snapshot listing, a restore to a fresh directory, a
    verification at rate 1.0, the zip of one subdirectory, backup #2
    after 4 writes of 4 KiB, and the metrics render.  The tree: files of
    log-uniform sizes (the store phase's) in 8 directories, a symlink, a
    hard link and a ``*.tmp`` file the job excludes.  Checks: the
    restored tree's sha256 per file equals the source's (the excluded
    file absent, the link and hard link kept), the verification reports
    no corrupt chunk, the zip's members equal the subdirectory's files,
    backup #2 stores again only the chunks around the writes (every
    other chunk of #1 at its offset in #2), and the server process's
    render counts K1, K2 and K3 launches.  With ``sync_peer`` (a
    datastore an earlier phase left), a pull sync row with that
    ``peer_path`` is added over the API after backup #2, run and polled
    until it succeeds, and the render's ``pbs_plus_sync_*`` families
    count its work."""
    import aiohttp

    from pbs_plus_tpu_torch.pxar.datastore import (DynamicIndex,
                                                   parse_snapshot_ref)
    from pbs_plus_tpu_torch.utils import mtls

    t_phase = time.perf_counter()
    src = os.path.join(root, "src")
    files = store_files(WEB_BYTES, seed + 500)
    rels = [os.path.join(f"d{i % WEB_DIRS}", f"f{i:05d}")
            for i in range(len(files))]
    for k in range(WEB_DIRS):
        os.makedirs(os.path.join(src, f"d{k}"), exist_ok=True)

    def write(i):
        s, e = files[i]
        blob = np.random.default_rng(seed + 10_000 + i).bytes(e - s)
        with open(os.path.join(src, rels[i]), "wb") as f:
            f.write(blob)
        return rels[i], hashlib.sha256(blob).hexdigest()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        want = dict(pool.map(write, range(len(files))))
    os.symlink(rels[0], os.path.join(src, "ln"))
    os.link(os.path.join(src, rels[1]), os.path.join(src, "hard"))
    want["hard"] = want[rels[1]]
    with open(os.path.join(src, "skip.tmp"), "wb") as f:
        f.write(b"excluded by the job row" * 100)
    write_s = time.perf_counter() - t0

    def tree_digests(top):
        """{rel: sha256 hex or ("link", target)} of every file under top,
        hashed on 8 threads."""
        paths = []
        for dp, _dn, fn in os.walk(top):
            paths += [os.path.join(dp, n) for n in fn]

        def one(p):
            rel = os.path.relpath(p, top)
            if os.path.islink(p):
                return rel, ("link", os.readlink(p))
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for blk in iter(lambda: f.read(8 << 20), b""):
                    h.update(blk)
            return rel, h.hexdigest()
        with ThreadPoolExecutor(8) as pool:
            return dict(pool.map(one, paths))

    # the hashlib yardstick for the verification: one core over the tree
    t0 = time.perf_counter()
    for rel in rels:
        h = hashlib.sha256()
        with open(os.path.join(src, rel), "rb") as f:
            for blk in iter(lambda: f.read(8 << 20), b""):
                h.update(blk)
    hashlib_s = time.perf_counter() - t0

    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = {n: os.path.join(root, f"{n}.stderr") for n in ("server", "agent")}
    cmd = [sys.executable, "-m", "pbs_plus_tpu_torch"]
    server_args = ["server", "--datastore", os.path.join(root, "ds"),
                   "--state-dir", os.path.join(root, "state"),
                   "--cert-dir", os.path.join(root, "certs"),
                   "--host", "127.0.0.1", "--arpc-port", "0",
                   "--web-port", "0", "--print-token", "--device", DEVICE]
    if WEB_CHUNK_AVG:
        server_args += ["--chunk-avg", str(WEB_CHUNK_AVG)]
    procs, children, agent = [], set(), None
    out = {"phase": "web", "tree_bytes": WEB_BYTES, "files": len(files),
           "write_s": write_s}
    try:
        t0 = time.perf_counter()
        with open(logs["server"], "w") as err:
            server = subprocess.Popen(cmd + server_args, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=err,
                                      text=True)
        procs.append(server)
        lines = _read_line(server, lambda s: s.startswith("api token"),
                           WEB_PORT_TIMEOUT)
        out["server_start_s"] = time.perf_counter() - t0
        ports = lines[-3].split("aRPC :")[1].split(", web :")
        arpc, web = int(ports[0]), int(ports[1])
        boot_tok, api_tok = lines[-2].split()[-1], lines[-1].split()[-1]
        t0 = time.perf_counter()
        with open(logs["agent"], "w") as err:
            agent = subprocess.Popen(
                cmd + ["agent", "--hostname", "web0",
                       "--server", f"127.0.0.1:{arpc}",
                       "--state-dir", os.path.join(root, "agent"),
                       "--bootstrap-url", f"http://127.0.0.1:{web}",
                       "--bootstrap-token", boot_tok,
                       "--snapshots", "direct"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        procs.append(agent)
        _read_line(agent, lambda s: s.startswith("bootstrapped"),
                   WEB_PORT_TIMEOUT)
        out["agent_enrol_s"] = time.perf_counter() - t0
        base = f"http://127.0.0.1:{web}"
        api = base + "/api2/json/d2d"
        dest = os.path.join(root, "restored")
        payload = sum(e - s for s, e in files)

        async def drive():
            auth = {"Authorization": f"Bearer {api_tok}"}
            async with aiohttp.ClientSession(headers=auth) as http:
                async def call(method, url, body=None, raw=False):
                    async with http.request(method, url, json=body) as r:
                        data = await r.read()
                        check(r.status == 200, f"web: {method} {url}: "
                                               f"{r.status} {data[:500]!r}")
                    return data if raw else json.loads(data)

                async def until(fn, what):
                    t_end = time.monotonic() + WEB_PORT_TIMEOUT
                    while True:
                        v = await fn()
                        if v:
                            return v
                        check(time.monotonic() < t_end, f"web: {what} "
                              f"not done in {WEB_PORT_TIMEOUT} s")
                        check(all(p.poll() is None for p in procs),
                              f"web: a process exited during {what}")
                        await asyncio.sleep(0.1)

                # enrolment of a second host, timed, over the same route
                tok = await call("POST", api + "/token")
                csr = mtls.make_csr(mtls.generate_private_key(), "web-probe")
                t0 = time.perf_counter()
                async with aiohttp.ClientSession() as anon:
                    async with anon.post(base + "/plus/agent/bootstrap", json={
                            "hostname": "web-probe", "csr": csr.decode(),
                            "token_id": tok["token_id"],
                            "token_secret": tok["token_secret"]}) as r:
                        boot = await r.json()
                        check(r.status == 200 and "cert" in boot,
                              f"web: bootstrap: {r.status} {boot}")
                out["bootstrap_ms"] = (time.perf_counter() - t0) * 1e3

                await call("POST", api + "/target",
                           {"name": "web0", "kind": "agent",
                            "hostname": "web0"})

                async def connected():
                    rows = (await call("GET", api + "/target"))["data"]
                    return any(t["name"] == "web0" and t["connected"]
                               for t in rows)
                await until(connected, "the agent's control session")
                job = (await call("POST", api + "/backup", {
                    "id": "web", "target": "web0", "source_path": src,
                    "exclusions": ["*.tmp"]}))["data"]
                check(job["chunker"] == "cuda",
                      f"web: the job's default chunker is {job['chunker']}")

                async def backup(n):
                    before = {t["upid"] for t in (await call(
                        "GET", api + "/tasks?job=web"))["data"]}
                    t0 = time.perf_counter()
                    check((await call("POST", api + "/backup/web/run"))[
                        "started"], f"web: backup #{n} not started")

                    async def done():
                        ts = [t for t in (await call(
                            "GET", api + "/tasks?job=web"))["data"]
                            if t["upid"] not in before]
                        return ts and ts[0]["status"] != "running" and ts[0]
                    task = await until(done, f"backup #{n}")
                    s = time.perf_counter() - t0
                    check(task["status"] == "success",
                          f"web: backup #{n}: {task}")
                    return task, s
                task1, out["backup1_s"] = await backup(1)
                snaps = (await call("GET", api + "/snapshots"))["data"]
                check(len(snaps) == 1, f"web: snapshots {snaps}")
                snap1 = snaps[0]["snapshot"]
                check(snaps[0]["payload_size"] >= payload,
                      f"web: payload {snaps[0]['payload_size']} < {payload}")

                t0 = time.perf_counter()
                rid = (await call("POST", api + "/restore", {
                    "target": "web0", "snapshot": snap1,
                    "destination": dest}))["restore_id"]

                async def restored():
                    r = (await call("GET", api + f"/restore/{rid}"))["data"]
                    return r["status"] in ("success", "error") and r
                row = await until(restored, "the restore")
                out["restore_s"] = time.perf_counter() - t0
                check(row["status"] == "success", f"web: restore: {row}")

                await call("POST", api + "/verification",
                           {"id": "web-v", "sample_rate": 1.0})
                t0 = time.perf_counter()
                check((await call("POST", api + "/verification/web-v/run"))[
                    "started"], "web: verification not started")

                async def verified():
                    v = (await call(
                        "GET", api + "/verification/web-v/results"))["data"]
                    return v.get("last_status") and v
                ver = await until(verified, "the verification")
                out["verification_s"] = time.perf_counter() - t0

                zdir = f"d{WEB_DIRS // 2}"
                t0 = time.perf_counter()
                zbytes = await call(
                    "GET", api + f"/snapshot-zip?snapshot={snap1}&path={zdir}",
                    raw=True)
                out["zip_s"] = time.perf_counter() - t0

                # backup #2 after WRITES in-place writes of WRITE_BYTES
                rng = np.random.default_rng(seed + 501)
                big = [i for i, (s, e) in enumerate(files)
                       if e - s >= 2 * WRITE_BYTES]
                for i in rng.choice(big, WRITES, replace=False):
                    s, e = files[i]
                    off = int(rng.integers(0, e - s - WRITE_BYTES))
                    with open(os.path.join(src, rels[i]), "r+b") as f:
                        f.seek(off)
                        f.write(rng.bytes(WRITE_BYTES))
                task2, out["backup2_s"] = await backup(2)
                snaps = (await call("GET", api + "/snapshots"))["data"]
                snap2 = next(s["snapshot"] for s in snaps
                             if s["snapshot"] != snap1)
                synced = None
                if sync_peer:
                    await call("POST", api + "/sync", {
                        "id": "web-sync", "direction": "pull",
                        "peer_path": sync_peer})
                    t0 = time.perf_counter()
                    check((await call("POST", api + "/sync/web-sync/run"))[
                        "started"], "web: the sync not started")

                    async def sync_done():
                        r = (await call(
                            "GET", api + "/sync/web-sync/results"))["data"]
                        return r.get("last_status") and r
                    synced = await until(sync_done, "the sync")
                    out["sync_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                render = (await call("GET", base + "/plus/metrics",
                                     raw=True)).decode()
                out["render_ms"] = (time.perf_counter() - t0) * 1e3
                return (task1, task2, snap1, snap2, ver, zdir, zbytes, render,
                        synced)
        task1, task2, snap1, snap2, ver, zdir, zbytes, render, synced = \
            asyncio.run(drive())
    except BaseException:
        for n, p in logs.items():
            print(f"chip_smoke: web: {n} stderr:\n{_tail(p)}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        if agent is not None:
            children |= set(_children(agent.pid))
        _stop(procs, children)

    mib = WEB_BYTES / 2**20
    out.update(
        backup1_mib_s=mib / out["backup1_s"],
        backup2_mib_s=mib / out["backup2_s"],
        restore_mib_s=mib / out["restore_s"],
        hashlib_s=hashlib_s, verification=ver["last_report"]["checked"],
        log1=task1["log"].strip(), log2=task2["log"].strip())
    # the restored tree, file by file, against the source as backed up
    got = tree_digests(dest)
    want_links = {"ln": ("link", rels[0])}
    check(got == {**want, **want_links},
          "web: the restored tree differs from the source: "
          f"{sorted(set(got) ^ set(want) ^ set(want_links))[:10]}")
    check(os.stat(os.path.join(dest, "hard")).st_ino
          == os.stat(os.path.join(dest, rels[1])).st_ino,
          "web: the hard link was not restored as one")
    rep = ver["last_report"]
    check(ver["last_status"] == "success" and rep["corrupt"] == []
          and rep["checked"] > 0, f"web: verification {ver}")
    # the zip of one subdirectory: its members are the source's files
    import io
    import zipfile
    zf = zipfile.ZipFile(io.BytesIO(zbytes))
    zwant = {os.path.basename(r): want[r] for r in rels
             if r.startswith(zdir + "/")}
    zgot = {n: hashlib.sha256(zf.read(n)).hexdigest() for n in zf.namelist()}
    check(zgot == zwant, f"web: zip members differ: {sorted(zgot)[:5]} vs "
                         f"{sorted(zwant)[:5]}")
    out["zip_members"], out["zip_bytes"] = len(zgot), len(zbytes)
    # backup #2 over #1: the chunks of #1 that #2 does not hold at the same
    # offset come in at most WRITES runs of at most 3 chunks (the chunk a
    # write lands in, a neighbour it straddles into, the resync)
    ds = os.path.join(root, "ds")
    idx = [DynamicIndex.parse(os.path.join(ds, parse_snapshot_ref(s).rel_dir,
                                           "root.pidx")) for s in (snap1, snap2)]
    kept2 = {(idx[1].chunk_bounds(i), idx[1].digest(i))
             for i in range(len(idx[1]))}
    gone = [i for i in range(len(idx[0]))
            if (idx[0].chunk_bounds(i), idx[0].digest(i)) not in kept2]
    runs = [r for r in np.split(np.array(gone, dtype=np.int64),
                                np.where(np.diff(gone) != 1)[0] + 1) if len(r)]
    check(0 < len(runs) <= WRITES and max(len(r) for r in runs) <= 3,
          f"web: backup #2 did not reuse #1's unchanged chunks: runs "
          f"{[list(r) for r in runs]} of {len(idx[0])} chunks")
    out["payload_chunks"] = [len(idx[0]), len(idx[1])]
    out["chunks_rewritten"] = len(gone)
    # the server process's own counts: the main path ran on its kernels
    launches = {}
    for line in render.splitlines():
        if line.startswith("pbs_plus_device_kernel_launches_total{"):
            k = line.split('kernel="')[1].split('"')[0]
            launches[k] = int(float(line.rsplit(" ", 1)[1]))
    check(set(launches) == {"candidate_mask", "sha256_chunks", "cuckoo_probe"},
          f"web: launch series {launches}")
    check(all(v > 0 for v in launches.values()),
          f"web: a kernel did not launch in the server: {launches}")
    out["launches"] = launches
    out["render_lines"] = len(render.splitlines())
    if sync_peer:
        rep = synced["report"]
        check(synced["last_status"] == "success"
              and rep["snapshots_synced"] > 0
              and rep["chunks_transferred"] > 0, f"web: the sync: {synced}")
        fams = {}
        for line in render.splitlines():
            if line.startswith("pbs_plus_sync_") and "_total" in line:
                fams[line.split("{")[0].split(" ")[0]] = float(
                    line.rsplit(" ", 1)[1])
        for fam in ("jobs", "snapshots", "chunks_probed", "probe_batches",
                    "chunks_transferred", "bytes_wire", "bytes_logical"):
            check(fams.get(f"pbs_plus_sync_{fam}_total", 0) > 0,
                  f"web: the render's pbs_plus_sync_{fam}_total: {fams}")
        out["sync"] = {"report": rep, "render": fams}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def kinds_phase(dev, P, stream0: np.ndarray, k1_cuts: list, seed: int,
                root: str, wire: str) -> dict:
    """The chunker kinds a backup row may name besides ``"cuda"``, against
    K1's cuts of stream 0 from phase ``main``: the native scan built by
    g++ from ``chunker/csrc/``; stream 0 through the scalar numpy scan (16
    MiB blocks with their 63-byte context, on 8 threads), the native scan
    (one thread and its segment threads) and the vector scan, then
    through the streaming chunkers of the ``scalar``, ``vector`` and
    ``sidecar:<addr>`` kinds in 4 MiB pieces, the sidecar a port
    ``DedupService`` on the card behind ``serve_sidecar``; K1 over the
    same stream beside them.  Then a port ``Server`` on the card runs one
    local-target job of stream 0's files (the store phase's file sizes)
    per row kind, ``"cpu"`` (the JAX default), ``"sidecar:<addr>"`` and
    ``"cuda"``: every file reads back, the three payload indexes are
    equal, the cpu job launches no kernel (hashlib inline and one insert
    a chunk through the index's host mirror, as the reference's inline
    path does), the sidecar's K1 and K2 run for the sidecar job, the
    cuda job launches K1, K2 and K3; the scan-byte counters
    and the render's ``pbs_plus_chunker_scan_bytes_total`` show nothing
    degraded (bytes under native, vector and sidecar, none under
    vector-numpy, no vector fallback, each stream bound to its kind).
    The server's datastore stays for the web phase's sync row."""
    from pbs_plus_tpu_torch.chunker import cpu, native, observe, vector
    from pbs_plus_tpu_torch.chunker.spec import WINDOW, select_cuts
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader
    from pbs_plus_tpu_torch.server import database
    from pbs_plus_tpu_torch.server.backup_job import make_chunker_factory
    from pbs_plus_tpu_torch.server.metrics import MetricsRegistry
    from pbs_plus_tpu_torch.server.store import Server, ServerConfig
    from pbs_plus_tpu_torch.sidecar import serve_sidecar

    t_phase = time.perf_counter()
    check(wire == "grpc", "the sidecar kind dials gRPC: grpc and msgpack "
                          "must import")
    n = len(stream0)
    t0 = time.perf_counter()
    built = native.available() and native.vec_available()
    build_s = time.perf_counter() - t0
    check(built, f"the native scan did not build with g++ from "
                 f"{native._SRC} into {native._SO}")
    # the vector self-test runs once a process, before the counters below:
    # its numpy reference scan is the one count under vector-numpy
    pre = observe.snapshot()["scan_bytes"].get("vector-numpy", 0)
    check(vector.available(), "the vector scan failed its self-test")
    obs0 = observe.snapshot()
    out = {"phase": "kinds", "stream_bytes": n, "g++_build_s": build_s,
           "vector_impl": vector.scan_impl_name(),
           "self_test_vector_numpy_bytes":
               obs0["scan_bytes"].get("vector-numpy", 0) - pre,
           "scans": {}}
    block = 16 << 20

    def numpy_block(off):
        return cpu.candidates(stream0[off:off + block], P,
                              prefix=stream0[max(0, off - WINDOW + 1):off],
                              global_offset=off, force_numpy=True)

    def numpy_scan():
        with ThreadPoolExecutor(8) as pool:
            return np.concatenate(list(pool.map(numpy_block,
                                                range(0, n, block))))

    for name, threads, fn in (
            ("numpy", 8, numpy_scan),
            ("native", 1, lambda: native.candidates(stream0, P, threads=1)),
            ("native_segments", os.cpu_count(),
             lambda: native.candidates(stream0, P)),
            ("vector", 1, lambda: vector.candidates(stream0, P))):
        t0 = time.perf_counter()
        ends = fn()
        s = time.perf_counter() - t0
        check(select_cuts(ends, n, P) == k1_cuts,
              f"kinds: the {name} scan's cuts != K1's of stream 0")
        out["scans"][name] = {"threads": threads, "seconds": s,
                              "mib_s": n / 2**20 / s,
                              "candidates": len(ends)}
    # K1 over the same stream: the kernel alone, and with the upload and
    # the candidates' download
    tables = rolling_hash.device_tables(P, dev)
    d0 = torch.from_numpy(stream0.copy()).to(dev)[None]
    k1_ms = cuda_ms(lambda: rolling_hash.candidate_mask(
        d0, tables, P.mask, P.magic), 3)
    del d0
    t0 = time.perf_counter()
    k1_ends = rolling_hash.candidate_ends_host(stream0, P, device=dev)
    k1_s = time.perf_counter() - t0
    check(select_cuts(k1_ends, n, P) == k1_cuts, "kinds: K1 over stream 0")
    out["scans"]["k1"] = {"kernel_ms": k1_ms,
                          "kernel_mib_s": n / 2**20 / (k1_ms / 1e3),
                          "with_copies_s": k1_s,
                          "with_copies_mib_s": n / 2**20 / k1_s}

    sc_server, sc_port, svc = serve_sidecar("127.0.0.1:0", params=P,
                                            device=dev, max_workers=8)
    addr = f"127.0.0.1:{sc_port}"
    # no filesystem is frozen or snapshotted: the local jobs read the
    # tree live
    from pbs_plus_tpu_torch.agent import snapshots
    orig_snapshots = snapshots.SnapshotManager

    class DirectSnapshots(orig_snapshots):
        def __init__(self, **kw):
            super().__init__(prefer_direct=True, **kw)
    snapshots.SnapshotManager = DirectSnapshots
    # each stream a sidecar factory degrades to the CPU chunker at open
    import logging

    degraded = []

    class Degradations(logging.Handler):
        def emit(self, record):
            degraded.append(record.getMessage())
    sc_log = logging.getLogger("pbs_plus_tpu_torch.sidecar.client")
    sc_handler = Degradations(logging.WARNING)
    sc_log.addHandler(sc_handler)
    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    server = None
    try:
        # the streaming chunkers of each kind, 4 MiB pieces
        out["streams"] = {}
        for kind in ("scalar", "vector", f"sidecar:{addr}"):
            factory = make_chunker_factory(kind, device=dev)
            bind = getattr(factory, "bind_stream", None)
            chunker = (bind(P) if bind else factory)(P)
            want = {"scalar": "cpu", "vector": "vector"}.get(kind, "sidecar")
            check(chunker.backend_name == want,
                  f"kinds: the {kind} stream bound {chunker.backend_name}")
            cuts = []
            t0 = time.perf_counter()
            for off in range(0, n, PIECE_BYTES):
                cuts += chunker.feed(stream0[off:off + PIECE_BYTES].tobytes())
            cuts += chunker.finalize()
            s = time.perf_counter() - t0
            check(cuts == k1_cuts, f"kinds: the {kind} stream's cuts != K1's")
            out["streams"][kind.split(":")[0]] = {"seconds": s,
                                                  "mib_s": n / 2**20 / s}
            if kind.startswith("sidecar:"):
                factory.client.close()

        # one local-target job per row kind through a port Server
        tree = os.path.join(root, "tree", "d")
        os.makedirs(tree)
        files = store_files(n, seed + 600)
        for i, (s, e) in enumerate(files):
            stream0[s:e].tofile(os.path.join(tree, f"f{i:05d}"))
        server = Server(ServerConfig(
            state_dir=os.path.join(root, "state"),
            cert_dir=os.path.join(root, "certs"),
            datastore_dir=os.path.join(root, "ds"), chunk_avg=P.avg_size),
            device=dev)
        run(server.start())
        server.scheduler.tick_s = 3600.0
        server.db.upsert_target("loc", "local",
                                root_path=os.path.dirname(tree))
        rows = {"cpu": "k-cpu", f"sidecar:{addr}": "k-sidecar",
                "cuda": "k-cuda"}
        ds = server.datastore.datastore
        out["jobs"] = {}
        payloads = {}
        for kind, jid in rows.items():
            server.db.upsert_backup_job(database.BackupJobRow(
                id=jid, target="loc", source_path="", backup_id=jid,
                chunker=kind))
            before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                      cuckoo.stats["device_probes"])
            async def job(jid=jid):
                check(server.enqueue_backup(jid), f"kinds: {jid} not queued")
                await server.job_queue.drain(timeout=900)
            t0 = time.perf_counter()
            run(job())
            s = time.perf_counter() - t0
            launches = dict(zip(
                ("candidate_mask", "sha256_chunks", "cuckoo_probe"),
                (a - b for a, b in zip(
                    (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                     cuckoo.stats["device_probes"]), before))))
            row = server.db.get_backup_job(jid)
            check(row.last_status == "success",
                  f"kinds: job {jid}: {row.last_status} {row.last_error}")
            ref = ds.last_snapshot("host", jid)
            man = ds.load_manifest(ref)
            label = kind.split(":")[0]
            check(man.get("chunker_backend") == label,
                  f"kinds: {jid} ran on {man.get('chunker_backend')}")
            if kind == "cpu":
                # the reference's inline path: hashlib, then one insert a
                # chunk through the index's host mirror; no batch to probe
                check(not any(launches.values()),
                      f"kinds: the cpu job launched a kernel: {launches}")
            elif kind == "cuda":
                check(all(launches.values()),
                      f"kinds: a kernel did not launch for {jid}: {launches}")
            else:
                check(launches["candidate_mask"] > 0
                      and launches["sha256_chunks"] > 0,
                      f"kinds: the sidecar's K1 or K2 did not launch for "
                      f"{jid}: {launches}")
            rd = SplitReader.open_snapshot(ds, ref)
            ents = [e for e in rd.entries() if e.is_file]
            check(len(ents) == len(files), f"kinds: {jid} entries")
            for e in ents:
                i = int(os.path.basename(e.path)[1:])
                s_, e_ = files[i]
                check(np.array_equal(np.frombuffer(rd.read_file(e), np.uint8),
                                     stream0[s_:e_]),
                      f"kinds: {jid} {e.path} does not read back")
            payloads[label] = list(rd.payload_index.records())
            out["jobs"][label] = {"seconds": s, "mib_s": n / 2**20 / s,
                                  "launches": launches,
                                  "chunks": man["payload_chunks"]}
        check(payloads["cpu"] == payloads["sidecar"] == payloads["cuda"],
              "kinds: the cpu, sidecar and cuda jobs' payload indexes differ")
        render = MetricsRegistry(server).render()
    finally:
        if server is not None:
            run(server.stop())
        loop.close()
        sc_server.stop(grace=None)
        snapshots.SnapshotManager = orig_snapshots
        sc_log.removeHandler(sc_handler)
    # the sidecar serves its own params only: a sidecar row's meta stream
    # (128 KiB chunks) degrades to the CPU chunker at open, as in the JAX
    # package; the payload streams must not
    meta_avg = max(1024, min(P.avg_size, 128 << 10))
    want = 1 if meta_avg != P.avg_size else 0
    check(len(degraded) == want
          and all(f"(avg={meta_avg}," in m for m in degraded),
          f"kinds: sidecar streams degraded: {degraded}")
    obs = observe.snapshot()
    delta = {b: v - obs0["scan_bytes"].get(b, 0)
             for b, v in obs["scan_bytes"].items()}
    series = {}
    for line in render.splitlines():
        if line.startswith("pbs_plus_chunker_"):
            series[line.rsplit(" ", 1)[0]] = float(line.rsplit(" ", 1)[1])
    rendered = {k.split('"')[1]: v for k, v in series.items()
                if k.startswith("pbs_plus_chunker_scan_bytes_total{")}
    check(delta.get("native", 0) > 0 and delta.get("vector", 0) > 0
          and delta.get("sidecar", 0) >= 2 * n
          and delta.get("vector-numpy", 0) == 0
          and obs["events"].get("vector_fallbacks", 0)
          == obs0["events"].get("vector_fallbacks", 0),
          f"kinds: a scan degraded: {delta}, events {obs['events']}")
    check(rendered.get("native", 0) > 0 and rendered.get("vector", 0) > 0
          and rendered.get("sidecar", 0) > 0
          and rendered.get("vector-numpy", 0)
          == obs0["scan_bytes"].get("vector-numpy", 0)
          and series.get("pbs_plus_chunker_vector_fallbacks_total") == 0,
          f"kinds: the render's chunker families: {series}")
    out.update(scan_bytes=delta, rendered_scan_bytes=rendered,
               launches={k: sum(j["launches"][k] for j in out["jobs"].values())
                         for k in ("candidate_mask", "sha256_chunks",
                                   "cuckoo_probe")},
               sidecar_stats={k: v for k, v in svc.get_stats({}).items()
                              if k != "chunker"},
               sidecar_degraded_streams=degraded,
               datastore=os.path.join(root, "ds"),
               phase_s=time.perf_counter() - t_phase)
    return out


SERVER_NOW = (2026, 7, 29, 2, 0, 10)   # past the rows' next 02:00 event


def hist_quantiles(text: str, name: str, labels: str) -> dict:
    """p50/p99 of the histogram child ``name{labels}`` from a Prometheus
    render: its cumulative ``le`` counts, interpolated within a bucket."""
    from pbs_plus_tpu_torch.server.metrics import quantile_from_counts
    edges, cum = [], []
    prefix = f"{name}_bucket{{{labels},le=\""
    for line in text.splitlines():
        if line.startswith(prefix):
            le, _, v = line[len(prefix):].partition("\"} ")
            if le != "+Inf":
                edges.append(float(le))
            cum.append(int(float(v)))
    counts = [b - a for a, b in zip([0] + cum[:-1], cum)]
    total = 0.0
    for line in text.splitlines():
        if line.startswith(f"{name}_sum{{{labels}}} "):
            total = float(line.split()[-1])
    n = cum[-1] if cum else 0
    # the top finite bucket is 10 s: a quantile past it reads as 10 s
    return {"count": n, "mean_s": total / n if n else 0.0,
            "p50_s": quantile_from_counts(tuple(edges), counts, 0.5),
            "p99_s": quantile_from_counts(tuple(edges), counts, 0.99),
            "top_bucket_s": edges[-1] if edges else None}


def server_phase(dev, P, streams: dict, seed: int, root: str, trees_root: str,
                 clock_hz: float) -> dict:
    """The port's server shell on the card: one ``Server(ServerConfig(...),
    device=dev)`` at the production defaults (tpxd layout, chunker
    "cuda", 4 MiB average chunks, the LocalStore's and the jobs
    manager's defaults, prune_keep_last=1) under ``root``; ``start()``
    (aRPC over mTLS on an ephemeral loopback port, the job socket, the
    scheduler and prune loops, stale-mount reaping off the loop); 8 port
    AgentLifecycles bootstrapped through 8 tokens and CSRs that
    ``bootstrap_agent`` signs, admitted by their pinned certificates;
    backup #1 of the backup_job phase's 8 agent trees fired by one
    scheduler tick (a second tick at the same time enqueues nothing); a
    scheduled verification; 4 writes of 4 KiB in each tree and backup #2
    queued over the job socket; prune and GC at keep_last=1, then the
    swept and kept digests probed through K3; the metrics render;
    ``stop()``."""
    import datetime as dt
    from cryptography import x509
    from cryptography.hazmat.primitives.serialization import Encoding
    from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
    from pbs_plus_tpu_torch.agent.snapshots import SnapshotManager
    from pbs_plus_tpu_torch.arpc import TlsClientConfig
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256
    from pbs_plus_tpu_torch.pxar.transfer import SplitReader
    from pbs_plus_tpu_torch.server import database
    from pbs_plus_tpu_torch.server.jobrpc import call_job_rpc
    from pbs_plus_tpu_torch.server.metrics import MetricsRegistry
    from pbs_plus_tpu_torch.server.store import Server, ServerConfig
    from pbs_plus_tpu_torch.utils import mtls

    t_phase = time.perf_counter()
    names = sorted(streams)
    trees = {n: os.path.join(trees_root, n) for n in names}
    rewritten = False
    if not all(os.path.isdir(os.path.join(trees[n], "d")) for n in names):
        # the backup_job phase's trees are gone: the streams cut into files
        rewritten = True
        for k, n in enumerate(names):
            d = os.path.join(trees[n], "d")
            os.makedirs(d, exist_ok=True)
            for i, (s, e) in enumerate(store_files(STREAM_BYTES,
                                                   seed + 100 + k)):
                streams[n][s:e].tofile(os.path.join(d, f"f{i:05d}"))
            with open(os.path.join(trees[n], "skip.tmp"), "wb") as f:
                f.write(b"excluded by the job row" * 100)

    loop = asyncio.new_event_loop()
    agent_loop = asyncio.new_event_loop()
    agent_thread = threading.Thread(target=agent_loop.run_forever,
                                    name="server-agents", daemon=True)
    agent_thread.start()
    run = loop.run_until_complete
    server = Server(ServerConfig(
        state_dir=os.path.join(root, "state"),
        cert_dir=os.path.join(root, "certs"),
        datastore_dir=os.path.join(root, "ds"), chunk_avg=P.avg_size,
        prune_keep_last=1, prune_schedule="yearly"), device=dev)
    check(server.config.chunker == "cuda"
          and server.config.datastore_format == "tpxd"
          and (CONFIG is not None
               or ServerConfig("", "", "").chunk_avg == P.avg_size),
          "the server runs the production defaults")
    # the phase ticks the scheduler by hand: its own loop ticks once at
    # start (no rows yet) and then not within the phase
    server.scheduler.tick_s = 3600.0
    ds = server.datastore.datastore
    lifecycles = {}
    out = {"phase": "server", "params": [P.avg_size, P.min_size, P.max_size],
           "trees_rewritten": rewritten,
           "max_concurrent": server.jobs.max_concurrent}

    def launches():
        return {"candidate_mask": rolling_hash.KERNEL.launches,
                "sha256_chunks": sha256.KERNEL.launches,
                "cuckoo_probe": cuckoo.stats["device_probes"]}

    def since(a):
        b = launches()
        return {k: b[k] - a[k] for k in a}

    def drain():
        """Drain the jobs plane; the most jobs that held a slot at once."""
        peak = [0]

        async def watch():
            while server.jobs.active_count:
                peak[0] = max(peak[0], server.jobs.running_count)
                await asyncio.sleep(0.05)

        async def both():
            await asyncio.gather(watch(), server.job_queue.drain(timeout=900))
        t = time.perf_counter()
        run(both())
        return time.perf_counter() - t, peak[0]

    def tree_files(n):
        d = os.path.join(trees[n], "d")
        return sorted(os.listdir(d))

    def counts_hold(tag, seen):
        """new/known/reused against the index: the new chunks of each
        group's newest snapshot are the digests no earlier snapshot had."""
        new = known = reused = chunks = 0
        digs = set()
        for n in names:
            ref = ds.last_snapshot("host", n)
            man = ds.load_manifest(ref)
            st = man["stats"]
            new += st["new_chunks"]
            known += st["known_chunks"]
            reused += st["ref_chunks"]
            chunks += man["meta_chunks"] + man["payload_chunks"]
            for idx in ds.load_indexes(ref):
                digs.update(idx.digest(i) for i in range(len(idx)))
        check(new == len(digs - seen) and new + known + reused == chunks,
              f"server {tag}: new {new}, known {known}, reused {reused}, "
              f"chunks {chunks}, novel digests {len(digs - seen)}")
        return digs, {"new_chunks": new, "known_chunks": known,
                      "reused_chunks": reused, "chunks": chunks}

    try:
        t = time.perf_counter()
        run(server.start())
        out["start_ms"] = (time.perf_counter() - t) * 1e3
        sock = os.path.join(server.config.state_dir, "job.sock")
        check(os.path.exists(sock) and len(server._tasks) == 2
              and server.mount_service is not None,
              "start(): the job socket, the scheduler and prune loops, the "
              "mount service")

        # bootstrap: a token and a CSR an agent, admitted by pinned DER
        ders = {}
        for n in names:
            tid, secret = server.issue_bootstrap_token()
            key = mtls.generate_private_key()
            cert = server.bootstrap_agent(n, mtls.make_csr(key, n), tid, secret)
            paths = [os.path.join(root, f"{n}.{ext}") for ext in ("pem", "key")]
            for p, blob in zip(paths, (cert, mtls.key_pem(key))):
                with open(p, "wb") as f:
                    f.write(blob)
            ders[n] = x509.load_pem_x509_certificate(cert).public_bytes(
                Encoding.DER)
            lifecycles[n] = AgentLifecycle(
                AgentConfig(hostname=n, server_host="127.0.0.1",
                            server_port=server.config.arpc_port,
                            tls=TlsClientConfig(*paths,
                                                server.certs.ca_cert_path),
                            job_isolation="task", drive_update_interval_s=0),
                snapshot_manager=SnapshotManager(prefer_direct=True))
            asyncio.run_coroutine_threadsafe(lifecycles[n].run(), agent_loop)

        async def registered():
            for n in names:
                await server.agents.wait_session(n, timeout=60)
        run(registered())
        pinned = [run(server._is_expected_host(n, ders[n])) for n in names]
        crossed = run(server._is_expected_host(names[0], ders[names[1]]))
        check(all(pinned) and not crossed,
              f"admission by pinned DER: {pinned}, crossed {crossed}")

        for k, n in enumerate(names):
            server.db.upsert_backup_job(database.BackupJobRow(
                id=f"srv-{k}", target=n, source_path=trees[n], backup_id=n,
                schedule="02:00", chunker="cuda", exclusions=["*.tmp"]))
        now = dt.datetime(*SERVER_NOW)

        # backup #1 from one scheduler tick
        rolling_hash.KERNEL.launches = 0
        sha256.KERNEL.launches = 0
        cuckoo.stats["device_probes"] = 0
        l0 = launches()
        enq0 = server.jobs.stats["enqueued"]
        t = time.perf_counter()
        run(server.scheduler.tick(now))
        tick_ms = (time.perf_counter() - t) * 1e3
        fired = server.jobs.stats["enqueued"] - enq0
        run(server.scheduler.tick(now))
        again = server.jobs.stats["enqueued"] - enq0 - fired
        check(fired == len(names) and again == 0,
              f"one tick fired {fired} backups, the second {again}")
        wall1, peak1 = drain()
        check(peak1 == len(names),
              f"backup #1: {peak1} jobs held a slot at once, want {len(names)}")
        b1_launches = since(l0)
        seen, stats1 = counts_hold("backup #1", set())

        # a scheduled verification over the store, on K2
        server.db.upsert_verification_job("srv-verify", schedule="02:00",
                                          sample_rate=1.0)
        l0 = launches()
        t = time.perf_counter()
        run(server.scheduler.tick(now))
        drain()
        verify_s = time.perf_counter() - t
        v_launches = since(l0)
        vrow = server.db.get_verification_job("srv-verify")
        vrep = json.loads(vrow["last_report"])
        check(vrow["last_status"] == "success" and vrep["corrupt"] == []
              and vrep["checked"] > 0,
              f"scheduled verification: {vrow['last_status']}, "
              f"{ {k: vrep[k] for k in ('checked', 'corrupt', 'snapshots')} }")
        check(v_launches["sha256_chunks"] > 0,
              f"K2 did not launch under the scheduled verification: "
              f"{v_launches}")
        # hashlib over the same files (the sources, unchanged since #1),
        # and K2's bound: the longest file's chain at the per-round floor
        lens, t_hash = [], 0.0
        for snap in vrep["snapshots"]:
            n = snap.split("/")[1]
            for f in tree_files(n):
                with open(os.path.join(trees[n], "d", f), "rb") as fh:
                    data = fh.read()
                t = time.perf_counter()
                hashlib.sha256(data).digest()
                t_hash += time.perf_counter() - t
                lens.append(len(data))

        # 4 writes of 4 KiB in each tree, then backup #2 over the job socket
        rng = np.random.default_rng(seed + 900)
        for n in names:
            fs = tree_files(n)
            for _ in range(WRITES):
                p = os.path.join(trees[n], "d", fs[int(rng.integers(len(fs)))])
                size = os.path.getsize(p)
                with open(p, "r+b") as f:
                    f.seek(int(rng.integers(0, max(1, size - WRITE_BYTES))))
                    f.write(rng.bytes(min(WRITE_BYTES, size)))
        l0 = launches()
        rtts = []

        async def queue_all():
            for k in range(len(names)):
                t = time.perf_counter()
                resp = await call_job_rpc(sock, {"op": "backup_queue",
                                                 "job_id": f"srv-{k}"})
                rtts.append((time.perf_counter() - t) * 1e3)
                check(resp == {"ok": True, "started": True},
                      f"job socket backup_queue srv-{k}: {resp}")
        t = time.perf_counter()
        run(queue_all())
        wall2, peak2 = drain()
        wall2 = time.perf_counter() - t
        b2_launches = since(l0)
        seen2, stats2 = counts_hold("backup #2", seen)
        check(stats2["known_chunks"] > 0
              and stats2["new_chunks"] < stats2["chunks"] // 2,
              f"backup #2 did not find the unchanged chunks known: {stats2}")

        async def ask():
            out = []
            for k in range(len(names)):
                t = time.perf_counter()
                out.append(await call_job_rpc(sock, {"op": "status",
                                                     "job_id": f"srv-{k}"}))
                rtts.append((time.perf_counter() - t) * 1e3)
            out.append(await call_job_rpc(sock, {"op": "list"}))
            return out
        answers = run(ask())
        check(all(a["ok"] and a["job"]["last_status"] == "success"
                  and not a["job"]["running"] for a in answers[:-1])
              and sorted((j["id"], j["last_status"], j["running"])
                         for j in answers[-1]["jobs"])
              == [(f"srv-{k}", "success", False) for k in range(len(names))],
              f"job socket status/list: {answers}")
        tasks = server.db.list_tasks(limit=1000)
        check(not server.db.list_running_tasks()
              and sorted(t["status"] for t in tasks)
              == ["success"] * (2 * len(names) + 1),
              f"task rows: {sorted(t['status'] for t in tasks)}")

        # prune and GC: backup #1's snapshots go, their own chunks are
        # swept and their digests discarded from the device table
        before = set(ds.chunks.iter_digests())
        first = sorted(str(ds.list_snapshots("host", n)[0]) for n in names)
        idx = ds.chunks.index
        timing = {"prune_s": 0.0, "sweep_s": 0.0, "discard_s": 0.0,
                  "discarded": 0}
        tlock = threading.Lock()

        def timed_method(obj, name, key, count=False):
            orig = getattr(obj, name)

            def wrapped(*a, **kw):
                t = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    with tlock:
                        timing[key] += time.perf_counter() - t
                        if count:
                            timing["discarded"] += len(a[0])
            setattr(obj, name, wrapped)
        timed_method(ds, "remove_snapshot", "prune_s")
        timed_method(ds.chunks, "sweep", "sweep_s")
        timed_method(idx, "discard_many_acked", "discard_s", count=True)
        t = time.perf_counter()
        rep = run(server.run_prune(gc_grace_s=0.0))
        run_prune_s = time.perf_counter() - t
        for obj, name in ((ds, "remove_snapshot"), (ds.chunks, "sweep"),
                          (idx, "discard_many_acked")):
            delattr(obj, name)
        after = set(ds.chunks.iter_digests())
        swept = sorted(before - after)
        kept = sorted(after)
        check(sorted(rep.removed) == first,
              f"prune removed {rep.removed}, want backup #1's {first}")
        check(all(len(ds.list_snapshots("host", n)) == 1 for n in names)
              and rep.chunks_removed == len(swept) > 0
              and not (seen2 - after) and not (set(swept) & seen2),
              f"GC: removed {rep.chunks_removed}, swept {len(swept)}, "
              f"live digests missing {len(seen2 - after)}")
        up0 = dict(cuckoo.stats)
        l0 = launches()
        t = time.perf_counter()
        verdicts = idx.probe_batch(swept + kept)
        probe_ms = (time.perf_counter() - t) * 1e3
        probe_launches = since(l0)
        check(verdicts == [False] * len(swept) + [True] * len(kept),
              f"after GC: {sum(verdicts[:len(swept)])} swept digests probe "
              f"present, {len(kept) - sum(verdicts[len(swept):])} kept absent")
        check(probe_launches["cuckoo_probe"] > 0,
              f"K3 did not launch on the probe after GC: {probe_launches}")
        table = {k: cuckoo.stats[k] - up0[k]
                 for k in ("table_uploads", "row_uploads", "upload_bytes")}

        # every file of every kept snapshot reads back as its source, and
        # every stored chunk re-hashes to its name
        t = time.perf_counter()
        read = 0
        for n in names:
            rd = SplitReader.open_snapshot(ds, ds.last_snapshot("host", n))
            ents = [e for e in rd.entries() if e.is_file]
            check("skip.tmp" not in {e.path for e in rd.entries()}
                  and [e.path for e in ents]
                  == [f"d/{f}" for f in tree_files(n)],
                  f"server {n}: entries of the kept snapshot")
            for e in ents:
                got = rd.read_file(e)
                with open(os.path.join(trees[n], e.path), "rb") as fh:
                    check(got == fh.read(), f"server {n}: {e.path} does not "
                                            "read back")
                read += len(got)
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            ok = list(pool.map(
                lambda d: hashlib.sha256(ds.chunks.get(d)).digest() == d,
                kept))
        check(all(ok), "server: a stored chunk != hashlib")
        rehash_s = time.perf_counter() - t

        # the metrics render
        t = time.perf_counter()
        text = MetricsRegistry(server).render()
        render_ms = (time.perf_counter() - t) * 1e3
        gauges = {}
        for line in text.splitlines():
            for g in ("pbs_plus_dedup_index_probes_total",
                      "pbs_plus_dedup_index_inserts_total",
                      "pbs_plus_dedup_index_discards_total"):
                if line.startswith(g + " "):
                    gauges[g] = float(line.split()[-1])
        lat = {h: hist_quantiles(text, f"pbs_plus_job_{h}_seconds",
                                 'kind="backup"')
               for h in ("enqueue_to_grant", "grant_to_publish",
                         "enqueue_to_publish")}
        check(len(gauges) == 3 and all(v > 0 for v in gauges.values()),
              f"the render's index counters: {gauges}")
        check(lat["grant_to_publish"]["count"] == 2 * len(names),
              f"grant_to_publish count {lat['grant_to_publish']['count']}")
        total = {k: b1_launches[k] + v_launches[k] + b2_launches[k]
                 + probe_launches[k] for k in b1_launches}
        check(all(b1_launches[k] > 0 and b2_launches[k] > 0
                  for k in b1_launches),
              f"a kernel did not launch under the server: #1 {b1_launches}, "
              f"#2 {b2_launches}")
        mib = len(names) * STREAM_BYTES / 2**20
        out.update({
            "transport": "mtls", "agents": len(names),
            "tick_ms": tick_ms, "fired": fired, "second_tick_fired": again,
            "backups": [
                {"backup": 1, "via": "scheduler tick", "wall_s": wall1,
                 "mib_s": mib / wall1, "peak_running": peak1,
                 "launches": b1_launches, **stats1},
                {"backup": 2, "via": "job socket", "wall_s": wall2,
                 "mib_s": mib / wall2, "peak_running": peak2,
                 "launches": b2_launches, **stats2}],
            "job_socket_rtt_ms": pct(rtts),
            "latency": lat,
            "verification": {
                "seconds": verify_s, "checked": vrep["checked"],
                "snapshots": vrep["snapshots"], "bytes": sum(lens),
                "hashlib_s": t_hash, "launches": v_launches,
                "k2_bound_ms": k2_chain_ms(max(lens), clock_hz)},
            "prune": {"run_prune_s": run_prune_s, "prune_s": timing["prune_s"],
                      "gc_s": run_prune_s - timing["prune_s"],
                      "sweep_s": timing["sweep_s"],
                      "discard_s": timing["discard_s"],
                      "digests_discarded": timing["discarded"],
                      "snapshots_removed": len(rep.removed),
                      "chunks_removed": rep.chunks_removed,
                      "bytes_freed": rep.bytes_freed,
                      "probe_ms": probe_ms, "probed": len(verdicts),
                      "device_table": table,
                      "device_table_update": (
                          "whole upload" if table["table_uploads"]
                          else "row copies" if table["row_uploads"]
                          else "none")},
            "render_ms": render_ms, "render_lines": len(text.splitlines()),
            "render_index": gauges,
            "read_back_bytes": read, "read_back_s": read_s,
            "rehash_s": rehash_s, "stored_chunks": len(kept),
            "launches": total})
    finally:
        async def agents_stopped():
            await asyncio.wait_for(asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(
                    stop_lifecycles(lifecycles.values()), agent_loop)), 60)
        try:
            run(agents_stopped())
        finally:
            t = time.perf_counter()
            run(server.stop())
            out["stop_ms"] = (time.perf_counter() - t) * 1e3
            agent_loop.call_soon_threadsafe(agent_loop.stop)
            agent_thread.join(30)
            agent_loop.close()
            loop.close()
    check(not server.job_rpc._srv.is_serving() and not os.path.exists(sock)
          and all(t.done() for t in server._tasks),
          "stop(): the job socket closed and the tasks ended")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def index_phase(dev, seed: int) -> dict:
    """The store's DedupIndex at a server's defaults (phase 13)."""
    from pbs_plus_tpu_torch.ops import cuckoo
    from pbs_plus_tpu_torch.pxar import chunkindex, digestlog
    from pbs_plus_tpu_torch.utils import trace

    def mirror_equal(ix) -> bool:
        c = ix._cuckoo
        t = c.device_table().cpu().numpy()
        return np.array_equal(t, c._table.view(np.int64).reshape(c.n_buckets, -1))

    def probe_exact(ix, batch, truth, what) -> list[bool]:
        got = ix.probe_batch(batch)
        check(got == [d in truth for d in batch], f"index {what} != a Python set")
        return got

    rng = np.random.default_rng(seed + 13)
    spill = os.path.join(SCRATCH, "index")
    shutil.rmtree(spill, ignore_errors=True)
    for k in cuckoo.stats:
        cuckoo.stats[k] = 0
    m0 = chunkindex.metrics_snapshot()
    idx = chunkindex.DedupIndex(budget_mb=INDEX_BUDGET_MB, seed=seed,
                                spill_dir=spill, resident_mb=INDEX_RESIDENT_MB,
                                device=dev)
    check(idx.table_bytes == INDEX_BUDGET_MB << 20, "the table fills its budget")
    pre = digests_of(rng, INDEX_PRELOAD)
    t0 = time.perf_counter()
    added = sum(idx.insert_many(pre[i:i + INDEX_INSERT_BATCH])
                for i in range(0, len(pre), INDEX_INSERT_BATCH))
    preload_s = time.perf_counter() - t0
    truth = set(pre)
    check(added == len(truth) == len(idx), "the preload is counted exactly")
    spilled = len(pre) * 112 > INDEX_RESIDENT_MB << 20
    check(idx.digestlog.segment_count >= int(spilled), "the memtable spilled")
    preload_launches = cuckoo.stats["device_probes"]

    # probe-then-insert in batches of 1,024 and of 64, half present
    def traffic(n_batches, size):
        up_ms, probe_ms, ins_ms = [], [], []
        for _ in range(n_batches):
            present = [pre[j] for j in rng.integers(0, len(pre), size // 2)]
            batch = present + digests_of(rng, size - size // 2)
            batch = [batch[j] for j in rng.permutation(size)]
            want = [d in truth for d in batch]
            t0 = time.perf_counter()
            idx._cuckoo.device_table()          # the rows the last insert wrote
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = idx.probe_batch(batch)
            t2 = time.perf_counter()
            novel = [d for d, g in zip(batch, got) if not g]
            idx.insert_many(novel)
            t3 = time.perf_counter()
            check(got == want, f"index probe at {size} != a Python set")
            truth.update(novel)
            up_ms.append((t1 - t0) * 1e3)
            probe_ms.append((t2 - t1) * 1e3)
            ins_ms.append((t3 - t2) * 1e3)
        return up_ms, probe_ms, ins_ms

    for k in cuckoo.stats:
        cuckoo.stats[k] = 0
    hist = "pbs_plus_digestlog_confirm_read_seconds"
    r0 = digestlog.metrics_snapshot()["confirm_reads"]
    h0 = trace.histograms().get(hist, {"sum_s": 0.0})["sum_s"]
    up_big, probe_big, ins_big = traffic(INDEX_PROBES // 1024, 1024)
    # the store's loop: the upload (inside probe_batch in real use), the
    # probe and the insert of the novel half; digest making and the set
    # check are left out
    big_s = (sum(up_big) + sum(probe_big) + sum(ins_big)) / 1e3
    confirm_reads = digestlog.metrics_snapshot()["confirm_reads"] - r0
    confirm_read_s = trace.histograms()[hist]["sum_s"] - h0 if confirm_reads else 0.0
    up_small, probe_small, ins_small = traffic(INDEX_SMALL_BATCHES, 64)
    traffic_stats = dict(cuckoo.stats)
    if dev.type == "cuda":
        check(traffic_stats["device_probes"] >= INDEX_PROBES // 1024
              + INDEX_SMALL_BATCHES, f"K3 did not run per probe batch: {traffic_stats}")
    check(mirror_equal(idx), "device table != host mirror after the traffic")
    m1 = chunkindex.metrics_snapshot()

    # a 1,024 batch's probe by layer: the filter pass (K3 with its upload
    # of the digests and download of the verdicts) and the exact confirm
    # of its positives against the memtable and the spilled segments
    filter_ms, confirm_ms = [], []
    for _ in range(64):
        batch = [pre[j] for j in rng.integers(0, len(pre), 512)] \
            + digests_of(rng, 512)
        arr = np.frombuffer(b"".join(batch), np.uint8).reshape(-1, 32)
        t0 = time.perf_counter()
        pos = np.flatnonzero(idx._probe_arr(arr))
        t1 = time.perf_counter()
        idx.digestlog.flags_arr(batch, arr, pos)
        t2 = time.perf_counter()
        filter_ms.append((t1 - t0) * 1e3)
        confirm_ms.append((t2 - t1) * 1e3)

    # the same probes against the whole-table copy the reference makes per
    # batch, and K3 alone on the 64 MiB table
    t64 = idx._cuckoo._table.view(np.int64).reshape(idx.n_buckets, -1)
    full_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        torch.from_numpy(t64.copy()).to(dev)
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
    table = idx._cuckoo.device_table()
    k3 = {}
    for n in (1024, 64):
        d = torch.from_numpy(np.frombuffer(b"".join(pre[:n]), np.uint8)
                             .reshape(-1, 32).copy()).to(dev)
        k3[n] = {"device_ms": None, "event_ms_with_launches": None,
                 "bound_ms": n * (32 + 2 * cuckoo.BUCKET_BYTES + 1)
                 / HBM_BYTES_PER_S * 1e3}
        if dev.type == "cuda":
            # device time: the profiler's sum over K3's ~10 small kernels;
            # the event time around the call also holds their launches
            reps = 50
            _, k3_kernels = device_ms(
                lambda: [cuckoo._lookup(table, d) for _ in range(reps)])
            k3[n]["device_ms"] = sum(k3_kernels.values()) / reps
            k3[n]["event_ms_with_launches"] = cuda_ms(
                lambda: cuckoo._lookup(table, d), reps)

    # recovery: snapshot (a manifest over the segments), reload, same answers
    snap = os.path.join(spill, "snapshot")
    t0 = time.perf_counter()
    idx.save_snapshot(snap)
    save_s = time.perf_counter() - t0
    segments = idx.digestlog.segment_count
    resident = idx.resident_bytes
    sample = [pre[j] for j in rng.integers(0, len(pre), INDEX_RECOVERY_PROBES // 2)] \
        + digests_of(rng, INDEX_RECOVERY_PROBES // 2)
    before = probe_exact(idx, sample, truth, "probe before the reload")
    n_live = len(idx)
    del idx
    t0 = time.perf_counter()
    idx = chunkindex.DedupIndex(budget_mb=INDEX_BUDGET_MB, seed=seed,
                                spill_dir=spill, resident_mb=INDEX_RESIDENT_MB,
                                device=dev)
    check(idx.load_snapshot(snap), "the snapshot reloads")
    boot_s = time.perf_counter() - t0
    check(len(idx) == n_live, "the reload holds every digest")
    check(probe_exact(idx, sample, truth, "probe after the reload") == before,
          "answers changed across the reload")

    # discards: every INDEX_DISCARD_EVERY-th preloaded digest, then none
    # of them probes present
    gone = pre[::INDEX_DISCARD_EVERY]
    t0 = time.perf_counter()
    check(all(idx.discard_many_acked(gone)), "every discard is acked")
    discard_s = time.perf_counter() - t0
    truth.difference_update(gone)
    for i in range(0, len(gone), 1 << 16):
        check(not any(idx.probe_batch(gone[i:i + (1 << 16)])),
              "a discarded digest probes present")
    check(mirror_equal(idx), "device table != host mirror after the discards")
    n_after = len(idx)
    del idx, truth, pre

    # one growth under spill: the filter streams the live digests back
    grow_dir = os.path.join(SCRATCH, "grow")
    shutil.rmtree(grow_dir, ignore_errors=True)
    g = chunkindex.DedupIndex(budget_mb=GROW_BUDGET_MB, seed=seed,
                              spill_dir=grow_dir, device=dev)
    nb0 = g.n_buckets
    gd = digests_of(rng, GROW_INSERTS)
    t0 = time.perf_counter()
    for i in range(0, len(gd), INDEX_INSERT_BATCH):
        g.insert_many(gd[i:i + INDEX_INSERT_BATCH])
    grow_s = time.perf_counter() - t0
    check(g.n_buckets == 2 * nb0, f"the filter grew once: {nb0} -> {g.n_buckets}")
    gtruth = set(gd)
    probe_exact(g, gd[::64] + digests_of(rng, len(gd[::64])), gtruth,
                "probe after growth")
    check(mirror_equal(g), "device table != host mirror after growth")
    del g, gd, gtruth
    shutil.rmtree(SCRATCH, ignore_errors=True)
    n_probes = INDEX_PROBES + 64 * INDEX_SMALL_BATCHES
    return {"phase": "index", "budget_mb": INDEX_BUDGET_MB,
            "resident_mb": INDEX_RESIDENT_MB, "preloaded": INDEX_PRELOAD,
            "preload_s": preload_s, "preload_k3_launches": preload_launches,
            "probes": n_probes, "batch_1024_probes_per_s": INDEX_PROBES / big_s,
            "batch_1024_loop_s": big_s,
            "batch_1024_probe_only_probes_per_s":
            INDEX_PROBES / sum(probe_big) * 1e3,
            "batch_1024": {**pct(probe_big), "upload": pct(up_big),
                           "insert": pct(ins_big)},
            "batch_64": {**pct(probe_small), "upload": pct(up_small),
                         "insert": pct(ins_small)},
            "batch_1024_layers": {"filter": pct(filter_ms),
                                  "confirm": pct(confirm_ms)},
            "batch_1024_confirm_reads": confirm_reads,
            "batch_1024_confirm_read_s": confirm_read_s,
            "k3_launches": traffic_stats["device_probes"],
            "k3_ms": {str(n): v for n, v in k3.items()},
            "uploads": {"whole": traffic_stats["table_uploads"],
                        "row_copies": traffic_stats["row_uploads"],
                        "bytes": traffic_stats["upload_bytes"],
                        "ms_total": sum(up_big) + sum(up_small),
                        "whole_table_ms_median": float(np.median(full_ms))},
            "false_positives": m1["false_positives"] - m0["false_positives"],
            "segments": segments, "resident_bytes": resident,
            "save_s": save_s, "boot_s": boot_s, "live": n_live,
            "discarded": len(gone), "discard_s": discard_s, "live_after": n_after,
            "growth": {"budget_mb": GROW_BUDGET_MB, "inserts": GROW_INSERTS,
                       "buckets": [nb0, 2 * nb0], "insert_s": grow_s}}


def dist_index_phase(dev, seed: int) -> dict:
    """Two shard nodes on the card behind DistIndexClient (phase 14)."""
    from pbs_plus_tpu_torch.parallel import DistIndexClient, ShardMap, dist_index

    root = os.path.join(SCRATCH, "dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    token = "chip-smoke"
    procs: dict[str, subprocess.Popen] = {}

    def spawn(sids):
        for sid in sids:
            procs[sid] = subprocess.Popen(
                [sys.executable, "-m", "pbs_plus_tpu_torch", "index-shard",
                 "--shard-id", sid, "--port", "0", "--token", token,
                 "--spill-dir", os.path.join(root, sid),
                 "--budget-mb", str(INDEX_BUDGET_MB),
                 "--resident-mb", str(INDEX_RESIDENT_MB),
                 "--snapshot", os.path.join(root, f"{sid}.snap"),
                 "--device", dev.type],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=open(os.path.join(root, f"{sid}.err"), "wb"))
        out = {}
        for sid in sids:                          # started together
            line = {}
            t = threading.Thread(target=lambda s=sid: line.update(
                json.loads(procs[s].stdout.readline() or b"{}")), daemon=True)
            t.start()
            t.join(180)
            check(line.get("event") == "ready",
                  f"shard {sid} never came up: {open(os.path.join(root, sid + '.err')).read()[-2000:]}")
            out[sid] = f"http://127.0.0.1:{line['port']}"
        return out

    try:
        t0 = time.perf_counter()
        urls = spawn(["s0", "s1"])
        start_s = time.perf_counter() - t0
        cli = DistIndexClient(endpoints=list(urls.items()), token=token,
                              timeout_s=600)
        rng = np.random.default_rng(seed + 17)
        digs = digests_of(rng, DIST_INSERTS)
        t0 = time.perf_counter()
        added = sum(cli.insert_many(digs[i:i + INDEX_INSERT_BATCH])
                    for i in range(0, len(digs), INDEX_INSERT_BATCH))
        insert_s = time.perf_counter() - t0
        check(added == len(digs), f"inserted {added} of {len(digs)}")
        truth = set(digs)
        batches = []
        for _ in range(DIST_PROBES // 1024):
            b = [digs[j] for j in rng.integers(0, len(digs), 512)] \
                + digests_of(rng, 512)
            batches.append([b[j] for j in rng.permutation(1024)])
        w0 = dist_index.metrics_snapshot()
        ms, answers = [], []
        t0 = time.perf_counter()
        for b in batches:
            t1 = time.perf_counter()
            answers.append(cli.probe_batch(b))
            ms.append((time.perf_counter() - t1) * 1e3)
        probe_s = time.perf_counter() - t0
        w1 = dist_index.metrics_snapshot()
        for b, a in zip(batches, answers):
            check(a == [d in truth for d in b], "dist probe != a Python set")
        wire = w1["wire_requests"] - w0["wire_requests"]
        check(wire <= 2 * len(batches), f"{wire} wire requests for {len(batches)} batches")

        # rebalance to a third node: one owner per digest, same answers
        urls.update(spawn(["s2"]))
        new_map = ShardMap(list(urls.items()), epoch=cli.shard_map.epoch + 1)
        t0 = time.perf_counter()
        reb = cli.rebalance(new_map)
        rebalance_s = time.perf_counter() - t0
        held = {}
        for si, (sid, url) in enumerate(urls.items()):
            one = DistIndexClient(ShardMap([(sid, url)]), token=token, timeout_s=600)
            mine = list(one.digests())
            one.close()
            arr = np.frombuffer(b"".join(mine), np.uint8).reshape(-1, 32)
            check(bool((new_map.owner_indices(arr) == si).all()),
                  f"{sid} holds digests it does not own")
            held[sid] = mine
        check(sum(len(v) for v in held.values()) == len(truth)
              and set().union(*map(set, held.values())) == truth,
              "after the rebalance every digest has exactly one owner")
        for b, a in zip(batches, answers):
            check(cli.probe_batch(b) == a, "answers changed across the rebalance")
        cli.close()
    finally:
        exits = {}
        for sid, p in procs.items():
            try:
                tail = p.communicate(b"exit\n", timeout=180)[0].splitlines()
                exits[sid] = json.loads(tail[-1]) if tail else {}
            except (OSError, ValueError, subprocess.TimeoutExpired):
                p.kill()
                p.wait(30)
    for sid in procs:
        check(exits.get(sid, {}).get("event") == "exit"
              and os.path.exists(os.path.join(root, f"{sid}.snap")),
              f"shard {sid} did not exit cleanly with its snapshot")
    launches = {sid: e["device_probes"] for sid, e in exits.items()}
    if dev.type == "cuda":
        check(all(v > 0 for v in launches.values()),
              f"a shard node did not probe with K3: {launches}")
    shutil.rmtree(root, ignore_errors=True)
    return {"phase": "dist_index", "nodes": len(procs), "start_s": start_s,
            "inserts": DIST_INSERTS, "insert_s": insert_s,
            "probes": DIST_PROBES, "probe_s": probe_s,
            "probes_per_s": DIST_PROBES / probe_s, **pct(ms),
            "wire_requests": wire, "batches": len(batches),
            "rebalance": {**reb, "seconds": rebalance_s,
                          "held": {k: len(v) for k, v in held.items()}},
            "k3_launches": launches}


def similarity_index_phase(dev, chunks: list, digests: list, seed: int) -> dict:
    """SimilarityIndex on the card (phase 15)."""
    from pbs_plus_tpu_torch.ops import similarity
    from pbs_plus_tpu_torch.pxar import SimilarityIndex

    si = SimilarityIndex(device=dev)
    similarity.stats["content_sketch"] = 0
    t0 = time.perf_counter()
    n = si.presketch(digests, chunks, None)
    presketch_s = time.perf_counter() - t0
    launches = similarity.stats["content_sketch"]
    check(n == len(chunks), "presketch sketched every chunk")
    if dev.type == "cuda":
        check(launches > 0, "presketch did not run the content sketch")
    # a sample and near-duplicates of its first chunks through the write
    # path's calls, on the card and on the CPU: equal sketches and answers
    rng = np.random.default_rng(seed + 19)
    pick = np.linspace(0, len(chunks) - 1, SIMI_SAMPLE).astype(int)
    sample = [chunks[i] for i in pick]
    sdigs = [digests[i] for i in pick]
    variants, vdigs = [], []
    for c in sample[:SIMI_VARIANTS]:
        v = bytearray(c)
        for at in rng.integers(0, len(v) - 64, 3):
            v[at:at + 16] = rng.bytes(16)
        variants.append(bytes(v))
        vdigs.append(hashlib.sha256(v).digest())
    answers = {}
    for where in (dev, "cpu"):
        x = SimilarityIndex(device=where)
        out = []
        for ds, cs in ((sdigs, sample), (vdigs, variants)):
            x.presketch(ds, cs, None)
            for d, c in zip(ds, cs):
                s = x.take_sketch(d, c)
                out.append((s, x.take_candidate(d, s), x.candidate(s)))
                x.add(d, s, 0)
        answers[str(where)] = out
    check(answers[str(dev)] == answers["cpu"],
          "SimilarityIndex on the card != on the CPU")
    found = sum(1 for (_, cand, _), d in zip(answers["cpu"][SIMI_SAMPLE:], sdigs)
                if cand is not None and cand[0] == d)
    check(found > 0, "no near-duplicate found its base")
    return {"phase": "similarity_index", "chunks": len(chunks),
            "bytes": sum(len(c) for c in chunks), "presketch_s": presketch_s,
            "launches": {"content_sketch": launches},
            "sample": SIMI_SAMPLE, "variants": SIMI_VARIANTS,
            "variants_found_base": found}


def parallel_phase(dev, P, streams: dict, dstream, step_bounds: list,
                   step_digests: list, index, pre: np.ndarray, w_off: int,
                   win_plain: list, seed: int) -> tuple[dict, dict]:
    """The multi-device layer at full width (phase 12): the sharded step,
    sequence-parallel chunking, the data-axis fan-in of K1/K2 and the
    index-sharded probe, over meshes that repeat the card, and over the
    real cards where more than one is visible.  ``win_plain`` holds the
    plain K1's hits in each stream's ingest window (phase 11), which the
    fan-in's K1 is held to.  Returns the phase line and the numbers the
    torch_ops and kernels lines take."""
    from pbs_plus_tpu_torch.chunker.spec import WINDOW, select_cuts
    from pbs_plus_tpu_torch.convert import sharded_index_from_reference
    from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256, similarity
    from pbs_plus_tpu_torch.ops.rolling_hash import _nonzero_rows
    from pbs_plus_tpu_torch.parallel import (dist_index, make_mesh,
                                             make_seq_mesh,
                                             multichip_dedup_step,
                                             sp_candidate_mask,
                                             sp_chunk_stream)
    from pbs_plus_tpu_torch.parallel import mesh as mesh_mod
    from pbs_plus_tpu_torch.parallel.collectives import (halo_from_left,
                                                         scatter_rows)
    from pbs_plus_tpu_torch.parallel.sharded_step import (head_digests,
                                                          mask_counts)

    t_phase = time.perf_counter()
    dev = dstream.device        # the card with its index, as meshes name it
    names = sorted(streams)
    n_total = dstream.numel()
    rows = dstream.view(N_STREAMS, STREAM_BYTES)
    tables = rolling_hash.device_tables(P, dev)
    nb = index.n_buckets
    proj = similarity.simhash_projection(64)

    # the single-device answers, made before any count is zeroed: K1's row
    # counts of the 8 streams, the heads' digests by hashlib, and K1's mask
    # of the 8 streams concatenated into one 2 GiB stream
    ref_cand = rolling_hash.candidate_mask(rows, tables, P.mask, P.magic
                                           ).sum(dim=1).cpu().numpy()
    heads = [hashlib.sha256(streams[n][:STEP_CHUNK]).digest() for n in names]
    heads_np = np.frombuffer(b"".join(heads), np.uint8).reshape(-1, 32)
    one_mask = rolling_hash.candidate_mask(dstream, tables, P.mask, P.magic)
    nz = _nonzero_rows(one_mask.view(N_STREAMS, -1), N_STREAMS)
    one_pos = nz[:, 0] * STREAM_BYTES + nz[:, 1]
    one_cuts = select_cuts(one_pos + 1, n_total, P)
    sk_host, sk_host_s = timed(lambda: similarity.simhash_sketch_host(heads_np))
    # 256 Ki probes in batches of 1,024, half of each from the preload
    rng = np.random.default_rng(seed + 23)
    n_batches, half = PAR_PROBES // PAR_PROBE_BATCH, PAR_PROBE_BATCH // 2
    probes = np.concatenate([
        pre[rng.integers(0, len(pre), n_batches * half)].reshape(
            n_batches, half, 32),
        np.frombuffer(rng.bytes(32 * n_batches * half), np.uint8).reshape(
            n_batches, half, 32)], axis=1)

    def run(step_devs, seq_devs, fan_devs) -> tuple[dict, dict]:
        timer = cuda_ms if len(set(step_devs + seq_devs + fan_devs)) == 1 \
            else wall_ms
        out, nums = {}, {}
        # -- the sharded step over (data x index), the index sharded 2 ways
        mesh = make_mesh(devices=step_devs, index_parallel=PAR_INDEX)
        nd, ni = mesh.shape["data"], mesh.shape["index"]
        t0 = time.perf_counter()
        sidx = sharded_index_from_reference(index._table, index._known, mesh,
                                            n_buckets=nb, seed=seed)
        for d in heads[:N_STREAMS // 2]:
            sidx.insert(d)
        want_hits = cuckoo.lookup_host(sidx.inner._table, heads_np)
        check(want_hits.tolist() == [True] * (N_STREAMS // 2)
              + [False] * (N_STREAMS // 2),
              "the index holds exactly the heads of streams 0-3")
        heads_dev = [mesh.devices[i, 0] for i in range(nd)]
        shards = scatter_rows(rows, heads_dev)
        idx_tab = sidx.device_table()
        sync_all()
        index_s = time.perf_counter() - t0
        step = multichip_dedup_step(mesh, chunk_len=STEP_CHUNK, n_buckets=nb)

        def run_step():
            return step(shards, tables, idx_tab, proj, P.mask, P.magic)

        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rolling_hash.KERNEL.launches = 0
        sha256.KERNEL.launches = 0
        dist_index.stats["probe_local"] = 0
        similarity.stats["simhash"] = 0
        (cand, hits, sk, total), step_s = timed(run_step)
        launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                    "sha256_chunks": sha256.KERNEL.launches,
                    "probe_local": dist_index.stats["probe_local"],
                    "simhash": similarity.stats["simhash"]}
        peak = torch.cuda.max_memory_allocated(dev) - before
        check(launches == {"candidate_mask": nd, "sha256_chunks": nd,
                           "probe_local": nd * ni, "simhash": nd},
              f"sharded step launches: {launches}")
        cand = cand.cpu().numpy()
        check(np.array_equal(cand, ref_cand),
              "sharded step cand_count != one K1 mask's row counts")
        check(int(total) == int(ref_cand.sum()),
              "sharded step total_candidates != the sum")
        check(np.array_equal(hits.cpu().numpy(), want_hits),
              "sharded step hits != lookup_host on the unsharded mirror")
        sk = sk.cpu().numpy().astype(np.uint32)
        diff = np.unpackbits((sk ^ sk_host).astype(">u4").view(np.uint8),
                             axis=-1).reshape(N_STREAMS, -1).astype(bool)
        scores = (np.unpackbits(heads_np, axis=-1).astype(np.float64) * 2 - 1
                  ) @ proj.astype(np.float64)
        check((np.abs(scores[diff]) < SIM_FLIP_LIMIT).all(),
              "sharded step sketches != simhash_sketch_host beyond the flip rule")
        # the step's layers alone, on the same inputs: the functions the
        # step calls, one after another
        tables_on = {d: tables.to(d) for d in set(step_devs)}
        proj_on = {d: torch.from_numpy(proj.astype(np.float64)).to(d)
                   for d in set(step_devs)}

        def k1_layer():
            return [mask_counts(s, tables_on[s.device], P.mask, P.magic)
                    for s in shards]

        def k2_layer():
            return [head_digests(s, STEP_CHUNK) for s in shards]

        digs = k2_layer()
        check(b"".join(d.cpu().numpy().tobytes() for d in digs)
              == b"".join(heads), "sharded step head digests != hashlib")

        def probe_layer():
            return [dist_index.probe_row(mesh, idx_tab, d, nb, row={"data": i})
                    for i, d in enumerate(digs)]

        def simhash_layer():
            return [similarity._simhash(d, proj_on[d.device], 64) for d in digs]

        layers = {"k1_ms": timer(k1_layer, 3), "k2_ms": timer(k2_layer, 2),
                  "probe_ms": timer(probe_layer, 10),
                  "simhash_ms": timer(simhash_layer, 10)}
        step_ms = timer(run_step, 2)
        # the plain K1 of the step's rows, one row at a time
        t0 = time.perf_counter()
        for r in range(N_STREAMS):
            got = rolling_hash.candidate_mask_plain(
                rows[r:r + 1], tables, P.mask, P.magic).sum()
            check(int(got) == int(ref_cand[r]),
                  f"plain K1 count of stream {r} != the kernel's")
        sync_all()
        k1_plain_ms = (time.perf_counter() - t0) * 1e3
        out["step"] = {
            "mesh": mesh.shape, "devices": sorted({str(d) for d in step_devs}),
            "chunk_len": STEP_CHUNK, "hits": int(want_hits.sum()),
            "total_candidates": int(total), "sketch_flips": int(diff.sum()),
            "launches": launches, "seconds": step_s, "ms": step_ms,
            "layers": layers, "k1_plain_ms": k1_plain_ms,
            "peak_extra_bytes": peak, "index_setup_s": index_s}
        # data shards whose launches queue one after another on one card
        per_card = max(heads_dev.count(d) for d in heads_dev)
        nums["step"] = {"ms": step_ms, "launches": launches,
                        "layers": layers, "k1_plain_ms": k1_plain_ms,
                        "shards_per_card": per_card}

        # -- the index-sharded probe: 256 Ki probes in batches of 1,024
        want = cuckoo.lookup_host(sidx.inner._table, probes.reshape(-1, 32))
        dist_index.stats["probe_local"] = 0
        got, probe_s = timed(lambda: np.concatenate(
            [sidx.probe(b).cpu().numpy() for b in probes]))
        pl = dist_index.stats["probe_local"]
        check(pl == n_batches * nd * ni, f"sharded probe launches: {pl}")
        check(np.array_equal(got, want), "sharded probe != lookup_host")
        check(got.reshape(n_batches, -1)[:, :half].all(),
              "every preloaded digest is found by the sharded probe")
        batch_dev = torch.from_numpy(probes[0].copy()).to(dev)
        pl_ms = timer(lambda: dist_index.probe_row(mesh, idx_tab, batch_dev, nb,
                                                   row={"data": 0}), 10)
        out["sharded_index"] = {
            "preloaded": len(index), "probes": int(got.size),
            "batch": PAR_PROBE_BATCH, "present_found": int(
                got.reshape(n_batches, -1)[:, :half].sum()),
            "absent_maybe": int(got.reshape(n_batches, -1)[:, half:].sum()),
            "seconds": probe_s, "probes_per_s": got.size / probe_s,
            "launches": pl, "probe_local_ms_1024": pl_ms,
            "table": "re-uploaded whole after a change"}
        nums["probe_local"] = {"ms": pl_ms, "launches": pl, "shards": ni}
        del sidx, idx_tab, shards

        # -- sequence-parallel: the 8 streams as one 2 GiB stream
        seq_mesh = make_seq_mesh(devices=seq_devs)
        rolling_hash.KERNEL.launches = 0
        masks, sp_s = timed(lambda: sp_candidate_mask(seq_mesh, dstream, P))
        sp_launches = rolling_hash.KERNEL.launches
        check(sp_launches == len(seq_devs),
              f"sequence-parallel K1 launches: {sp_launches}")
        L = n_total // len(seq_devs)
        sp_pos = np.concatenate([_nonzero_rows(m[None], 1)[:, 1] + i * L
                                 for i, m in enumerate(masks)])
        check(np.array_equal(sp_pos, one_pos),
              "sequence-parallel mask positions != one K1 mask's")
        check(all(torch.equal(m, one_mask[i * L:(i + 1) * L].to(m.device))
                  for i, m in enumerate(masks)),
              "sequence-parallel masks != one K1 mask")
        cuts = sp_chunk_stream(seq_mesh, dstream, P)
        check(cuts == one_cuts, "sequence-parallel cuts != select_cuts")
        # the plain version of each shard's body, halo and all
        shards = [dstream[i * L:(i + 1) * L].to(d)
                  for i, d in enumerate(seq_devs)]
        halos = halo_from_left(shards, WINDOW - 1)
        sync_all()
        t0 = time.perf_counter()
        for i, (sh, ha) in enumerate(zip(shards, halos)):
            plain = rolling_hash.candidate_mask_plain(
                sh[None], tables.to(sh.device), P.mask, P.magic, ha[None])[0]
            if i == 0:
                plain[:WINDOW - 1] = False
            check(torch.equal(plain, masks[i]),
                  f"sequence-parallel shard {i}: K1 != plain")
        sync_all()
        sp_plain_ms = (time.perf_counter() - t0) * 1e3
        del masks, shards, halos
        sp_ms = timer(lambda: sp_candidate_mask(seq_mesh, dstream, P), 5)
        one_ms = cuda_ms(lambda: rolling_hash.candidate_mask(
            dstream, tables, P.mask, P.magic), 5)
        out["sequence_parallel"] = {
            "shards": len(seq_devs), "bytes": n_total,
            "candidates": int(len(one_pos)), "cuts": len(cuts),
            "launches": sp_launches, "seconds": sp_s, "ms": sp_ms,
            "one_device_ms": one_ms, "plain_ms": sp_plain_ms}
        nums["sp"] = {"ms": sp_ms, "one_ms": one_ms, "plain_ms": sp_plain_ms,
                      "launches": sp_launches}

        # -- the data-axis fan-in of the batched K1 and K2 dispatches
        bufs = [streams[n][w_off:w_off + INGEST_WINDOW] for n in names]
        hists = [streams[n][w_off - WINDOW + 1:w_off] for n in names]
        prev = mesh_mod.set_data_mesh(None)
        try:
            local, local_s = timed(lambda: rolling_hash.batched_candidate_hits(
                bufs, hists, tables, P))
            local_digs, local_sha_s = timed(
                lambda: sha256.sha256_stream_chunks(dstream, step_bounds))
            mesh_mod.set_data_mesh(make_seq_mesh(devices=fan_devs,
                                                 axis_name="data"))
            d1 = rolling_hash.stats["mesh_dispatches"]
            d2 = sha256.stats["mesh_dispatches"]
            rolling_hash.KERNEL.launches = 0
            fan, fan_s = timed(lambda: rolling_hash.batched_candidate_hits(
                bufs, hists, tables, P))
            k1_fan = rolling_hash.KERNEL.launches
            sha256.KERNEL.launches = 0
            fan_digs, fan_sha_s = timed(
                lambda: sha256.sha256_stream_chunks(dstream, step_bounds))
            k2_fan = sha256.KERNEL.launches
            rose = (rolling_hash.stats["mesh_dispatches"] - d1,
                    sha256.stats["mesh_dispatches"] - d2)
        finally:
            mesh_mod.set_data_mesh(prev)
        check(k1_fan == len(fan_devs) and k2_fan == len(fan_devs),
              f"fan-in launches: K1 {k1_fan}, K2 {k2_fan}")
        check(rose == (1, 1), f"fan-in mesh_dispatches rose by {rose}")
        check(len(local) == len(win_plain) and all(
            np.array_equal(a, b) for a, b in zip(local, win_plain)),
            "one-device batched candidate hits != plain K1")
        check(len(fan) == len(win_plain) and all(
            np.array_equal(a, b) for a, b in zip(fan, win_plain)),
            "fan-in candidate hits != plain K1")
        check(fan_digs == local_digs == step_digests,
              "fan-in digests != one device and hashlib")
        out["fan_in"] = {
            "devices": len(fan_devs), "k1_rows": [len(bufs), INGEST_WINDOW],
            "k2_chunks": len(step_bounds), "launches": {
                "candidate_mask": k1_fan, "sha256_chunks": k2_fan},
            "mesh_dispatches": {"candidate_mask": rose[0],
                                "sha256_chunks": rose[1]},
            "k1_s": fan_s, "k1_one_device_s": local_s,
            "k2_s": fan_sha_s, "k2_one_device_s": local_sha_s}
        nums["fan_in"] = {"k1": k1_fan, "k2": k2_fan}
        return out, nums

    n_par = PAR_DATA * PAR_INDEX
    line, nums = run([dev] * n_par, [dev] * SEQ_SHARDS, [dev] * FAN_IN_DEVICES)
    line = {"phase": "parallel", "mesh_devices": f"{dev} repeated", **line,
            "simhash_host_ms": sk_host_s * 1e3}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        n = min(8, 1 << (n_cards.bit_length() - 1))
        real = [torch.device("cuda", i) for i in range(n)]
        line["multi_card"], _ = run(real, real, real)
    else:
        line["multi_card"] = f"not run: {n_cards} CUDA device"
    line["seconds"] = time.perf_counter() - t_phase
    nums["simhash_host_ms"] = sk_host_s * 1e3
    return line, nums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fleet-child", nargs=3, metavar=("RUN", "DIR", "SIZES"),
                    help="one run of the fleet phase (the phase starts "
                         "these itself)")
    ap.add_argument("--fleet-only", type=int, default=0, metavar="N",
                    help="build the kernels and run only the fleet phase, "
                         "N times, going on past a failed run (its line "
                         "then has \"failed\"); exit 1 if any failed")
    args = ap.parse_args()
    if args.fleet_child:
        globals().update(json.loads(args.fleet_child[2]))
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 2
    if args.fleet_child:
        return fleet_child(*args.fleet_child[:2])
    if args.fleet_only:
        from pbs_plus_tpu_torch.ops import _build
        emit({"phase": "build", "seconds": _build.build(),
              "card": smi("name,power.limit")})
        failed = 0
        os.makedirs(SCRATCH, exist_ok=True)
        for r in range(args.fleet_only):
            root = tempfile.mkdtemp(prefix="fleet-", dir=SCRATCH)
            try:
                emit(dict(fleet_phase(torch.device(DEVICE), root), run=r))
            except CheckFailed as e:
                failed += 1
                emit({"phase": "fleet", "run": r, "failed": str(e)})
            finally:
                shutil.rmtree(root, ignore_errors=True)
        return 1 if failed else 0
    wire = sidecar_wire()       # the sidecar phase's transport, decided once

    from pbs_plus_tpu_torch.chunker.spec import (DEFAULT_PARAMS, TEST_PARAMS,
                                                 WINDOW, select_cuts)
    from pbs_plus_tpu_torch.models import (CudaChunker, DedupConfig,
                                           DedupPipeline, get_feeder,
                                           make_batch_hasher)
    from pbs_plus_tpu_torch.models import SimilarityModel, VerifyPipeline
    from pbs_plus_tpu_torch.ops import (_build, cuckoo, fingerprint, ingest,
                                        rolling_hash, sass, sha256, similarity)
    from pbs_plus_tpu_torch.ops._u32 import length_groups
    from pbs_plus_tpu_torch.sidecar import DedupService, SidecarClient, serve_sidecar
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
    b2_is_new = {n: [c.is_new for c in res2[n].chunks] for n in names}
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
    (_, prof_s), dev_ms = device_ms(lambda: timed(lambda: pipe.fingerprint_streams(streams)))
    busy_ms = sum(dev_ms.values())
    emit({"phase": "layers", "h2d_s": h2d_s, "mask_s": mask_s, "cuts_s": cuts_s, "sha_s": sha_s,
          "probe_s": probe_s, "profiled_chunk_fp_s": prof_s,
          "device_busy_ms": busy_ms if dev_ms else None,
          "device_busy_share": busy_ms / (prof_s * 1e3) if dev_ms else None,
          "top_device_ms": top(dev_ms, 8)})

    # the same streams through the store's fused-ingest collector
    fused = fused_ingest_phase(dev, P, streams, ref_bounds, ref_digests,
                               gib / stream_s)
    emit(fused)

    # the same streams as backups through two LocalStores, then the
    # verification job over both; the stores live on local disk under the
    # checkout and go at the end of the phase, also when a check fails
    os.makedirs(SCRATCH, exist_ok=True)
    store_root = tempfile.mkdtemp(prefix="store-", dir=SCRATCH)
    try:
        store_line, stores = store_phase(dev, P, streams, args.seed, store_root)
        emit(store_line)
        # tape ingestion: an MTF medium of streams 0-1 into two fresh stores
        tape_root = tempfile.mkdtemp(prefix="tape-", dir=SCRATCH)
        try:
            tape_line = tape_phase(dev, P, streams, args.seed, tape_root)
            emit(tape_line)
        finally:
            shutil.rmtree(tape_root, ignore_errors=True)
        # the fleet: 500 loopback agents through run_fleet, then two
        # fleetproc workers over one datastore
        fleet_root = tempfile.mkdtemp(prefix="fleet-", dir=SCRATCH)
        try:
            fleet_line = fleet_phase(dev, fleet_root)
            emit(fleet_line)
        finally:
            shutil.rmtree(fleet_root, ignore_errors=True)
        ver_line = verification_phase(dev, stores, clock_hz)
        emit(ver_line)
        sync_line = sync_phase(dev, stores, store_root)
        emit(sync_line)
        mount_line = mount_phase(dev, stores, args.seed, store_root, clock_hz)
        emit(mount_line)
        del stores
    finally:
        shutil.rmtree(store_root, ignore_errors=True)
    # the agent backup job over the same streams, on its own stores
    job_root = tempfile.mkdtemp(prefix="backup-job-", dir=SCRATCH)
    try:
        job_line = backup_job_phase(dev, P, streams, args.seed, job_root)
        emit(job_line)
        # the server shell over the same agent trees, on its own store
        server_root = tempfile.mkdtemp(prefix="server-", dir=SCRATCH)
        try:
            server_line = server_phase(dev, P, streams, args.seed, server_root,
                                       os.path.join(job_root, "agents"),
                                       clock_hz)
            emit(server_line)
        finally:
            shutil.rmtree(server_root, ignore_errors=True)
    finally:
        shutil.rmtree(job_root, ignore_errors=True)
    # the host chunker kinds and the sidecar kind against K1's cuts, then
    # one local-target job per row kind through a port Server; its store
    # is the web phase's sync peer
    kinds_root = tempfile.mkdtemp(prefix="kinds-", dir=SCRATCH)
    try:
        kinds_line = kinds_phase(dev, P, streams[names[0]],
                                 [e for _, e in ref_bounds[names[0]]],
                                 args.seed, kinds_root, wire)
        emit(kinds_line)
        # the server and agent commands as two processes, driven over HTTP
        web_root = tempfile.mkdtemp(prefix="web-", dir=SCRATCH)
        try:
            web_line = web_phase(args.seed, web_root,
                                 sync_peer=kinds_line["datastore"])
            emit(web_line)
        finally:
            shutil.rmtree(web_root, ignore_errors=True)
    finally:
        shutil.rmtree(kinds_root, ignore_errors=True)
    store_launches = {k: sum(r["launches"][k] for st in store_line["stores"].values()
                             for r in st["backups"])
                      for k in ("candidate_mask", "sha256_chunks", "cuckoo_probe")}
    ver_launches = sum(st["k2_launches"] for st in ver_line["stores"].values())

    # 7. the sidecar route -----------------------------------------------------
    # the route an unmodified server takes (job rows with chunker =
    # "sidecar:<host:port>"): the service on the card, the index preloaded
    # like the main path's, 8 client threads streaming 4 MiB pages
    if wire == "grpc":
        server, port, svc = serve_sidecar("127.0.0.1:0", params=P, device=dev,
                                          max_workers=2 * N_STREAMS)
        client = SidecarClient(f"127.0.0.1:{port}")
    else:
        server, svc = None, DedupService(params=P, device=dev)
        client = InProcessClient(svc)
    check(svc.index.n_buckets == DedupConfig().index_buckets,
          "the sidecar's index has the production bucket count")
    t0 = time.perf_counter()
    check(client.insert_index(preload) == PRELOAD, "sidecar preload")
    sc_preload_s = time.perf_counter() - t0

    def sidecar_backup(strs, tag):
        got, errs = {}, []
        barrier = threading.Barrier(N_STREAMS)

        def agent(name):
            try:
                a = strs[name]
                cuts, digs = [], []
                barrier.wait()
                for off in range(0, len(a), PIECE_BYTES):
                    r = client.chunk(f"{tag}-{name}",
                                     a[off:off + PIECE_BYTES].tobytes(),
                                     eof=off + PIECE_BYTES >= len(a))
                    cuts += r["cuts"]
                    digs += r["digests"]
                got[name] = (cuts, digs)
            except BaseException as e:     # surfaced by the check below
                errs.append(repr(e))

        threads = [threading.Thread(target=agent, args=(n,)) for n in names]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        secs = time.perf_counter() - t
        check(not errs and not any(th.is_alive() for th in threads),
              f"sidecar clients failed: {errs}")
        return got, secs

    streams2 = rewrite(streams, args.seed)
    rolling_hash.KERNEL.launches = 0
    sha256.KERNEL.launches = 0
    cuckoo.stats["device_probes"] = 0
    similarity.stats["minhash"] = 0
    sc1, sc1_s = sidecar_backup(streams, "b1")
    b1_digests = [d for n in names for d in sc1[n][1]]
    check(client.insert_index(b1_digests) == len(set(b1_digests) - set(preload)),
          "InsertIndex of backup #1 counts its novel digests")
    sc2, sc2_s = sidecar_backup(streams2, "b2")
    b2_digests = [d for n in names for d in sc2[n][1]]
    present = client.probe_index(b2_digests)
    sigs = {n: client.snapshot_signature(sc1[n][1]) for n in names}
    sc_launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                   "sha256_chunks": sha256.KERNEL.launches,
                   "cuckoo_probe": cuckoo.stats["device_probes"],
                   "minhash": similarity.stats["minhash"]}
    check(all(v > 0 for v in sc_launches.values()),
          f"a kernel of the sidecar path did not launch: {sc_launches}")
    sc_stats = client.stats()
    client.close()
    if server is not None:
        server.stop(grace=None)
    for n in names:
        check(sc1[n] == ([e for _, e in ref_bounds[n]], ref_digests[n]),
              f"sidecar backup #1 cuts or digests of {n} != main path (hashlib)")
        check(sc2[n] == ([e for _, e in ref2_bounds[n]], ref2_digests[n]),
              f"sidecar backup #2 cuts or digests of {n} != main_backup2 (hashlib)")
        check(sigs[n] == [int(x) for x in similarity.minhash_signature_host(
            np.frombuffer(b"".join(sc1[n][1]), np.uint8).reshape(-1, 32), k=128)],
            f"sidecar Similarity of {n} != minhash_signature_host")
    # present/novel against main_backup2's is_new: equal, except that a
    # novel chunk repeated within backup #2 is not new the second time
    novel_seen: set[bytes] = set()
    for d, p, new in zip(b2_digests, present, [x for n in names for x in b2_is_new[n]]):
        if d in novel_seen:
            check(not p and not new, "sidecar probe of a repeated novel chunk")
        else:
            check(p == (not new), "sidecar ProbeIndex != main_backup2's is_new")
            if not p:
                novel_seen.add(d)
    check(sc_stats["use_tpu"] is (dev.type == "cuda")
          and sc_stats["bytes"] == 2 * N_STREAMS * STREAM_BYTES
          and sc_stats["index_size"] == len(set(preload) | set(b1_digests)),
          f"sidecar stats: {sc_stats}")
    emit({"phase": "sidecar", "wire": wire, "streams": N_STREAMS,
          "stream_bytes": STREAM_BYTES, "page": PIECE_BYTES,
          "preload_s": sc_preload_s, "backup1_s": sc1_s, "mib_s": gib / sc1_s,
          "backup2_s": sc2_s, "backup2_mib_s": gib / sc2_s,
          "probe": {"present": int(sum(present)), "novel": len(present) - int(sum(present))},
          "launches": sc_launches, "feeder": dict(get_feeder(dev).stats),
          "stats": {k: v for k, v in sc_stats.items() if k != "chunker"}})
    del streams2, sc1, sc2

    # 8. similarity (BASELINE.json config #5) --------------------------------
    srng = np.random.default_rng(args.seed + 11)
    sim_a = np.frombuffer(srng.bytes(32 * SIM_DIGESTS), np.uint8).reshape(-1, 32)
    # a second snapshot sharing half of the first one's chunks
    sim_b = np.concatenate([sim_a[:SIM_DIGESTS // 2], np.frombuffer(
        srng.bytes(32 * (SIM_DIGESTS - SIM_DIGESTS // 2)), np.uint8).reshape(-1, 32)])
    a_list = [bytes(r) for r in sim_a]
    b_list = [bytes(r) for r in sim_b]
    step_chunks = [streams[n][s:e].tobytes() for n in names for s, e in ref_bounds[n]]
    model = SimilarityModel(device=dev)
    check((model.simhash_bits, model.minhash_k) == (64, 128), "model defaults")
    for key in similarity.stats:
        similarity.stats[key] = 0
    t0 = time.perf_counter()
    sig_a = model.snapshot_signature(a_list)
    sig_b = model.snapshot_signature(b_list)
    sk_a = model.chunk_sketches(a_list)
    sk_b = model.chunk_sketches(b_list)
    pairs = model.near_duplicates(sk_a, sk_b, max_distance=SIM_MAX_DISTANCE)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = similarity.content_sketch_device(step_chunks, device=dev)
    cs_s = time.perf_counter() - t0
    sim_launches = dict(similarity.stats)
    check(all(v > 0 for v in sim_launches.values()),
          f"a program of the similarity path did not run: {sim_launches}")
    t0 = time.perf_counter()
    mh_host = similarity.minhash_signature_host(sim_a, k=128)
    mh_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(sig_a, mh_host) and np.array_equal(
        sig_b, similarity.minhash_signature_host(sim_b, k=128)),
        "minhash signature != minhash_signature_host")
    t0 = time.perf_counter()
    sk_host = similarity.simhash_sketch_host(sim_a, k=64)
    sh_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(sk_a, sk_host) and np.array_equal(
        sk_b, similarity.simhash_sketch_host(sim_b, k=64)),
        "simhash sketches != simhash_sketch_host")
    corner = similarity.pairwise_hamming(sk_a[:SIM_CORNER], sk_b[:SIM_CORNER],
                                         device=dev).cpu().numpy()
    t0 = time.perf_counter()
    corner_host = similarity.pairwise_hamming_host(sk_a[:SIM_CORNER], sk_b[:SIM_CORNER])
    ham_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(corner, corner_host), "Hamming corner != pairwise_hamming_host")
    check(pairs == hamming_pairs_host(sk_a, sk_b, SIM_MAX_DISTANCE),
          "near_duplicates != the host's pairs")
    check({(i, i) for i in range(SIM_DIGESTS // 2)} <= {(i, j) for i, j, _ in pairs},
          "near_duplicates finds the shared chunks")
    cs_idx = np.linspace(0, len(step_chunks) - 1, CS_SAMPLE).astype(int)
    cs_sample = [step_chunks[i] for i in cs_idx]
    t0 = time.perf_counter()
    cs_host = similarity.content_sketch_host(cs_sample)
    cs_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(cs[cs_idx], cs_host), "content sketches != content_sketch_host")
    emit({"phase": "similarity", "digests": SIM_DIGESTS, "pairs": len(pairs),
          "minhash_similarity": similarity.minhash_similarity(sig_a, sig_b),
          "model_s": sim_s, "content_sketch_chunks": len(step_chunks),
          "content_sketch_s": cs_s, "content_sketch_mib_s": gib / cs_s,
          "launches": sim_launches, "host_checked": {
              "minhash": 2, "simhash": 2 * SIM_DIGESTS,
              "hamming_corner": [SIM_CORNER, SIM_CORNER],
              "near_duplicates": "all pairs", "content_sketch": CS_SAMPLE}})

    # 9. verify --------------------------------------------------------------
    vp = VerifyPipeline(device=dev)
    sha256.KERNEL.launches = 0
    flip = len(step_chunks) // 2
    bad = list(step_chunks)
    bad[flip] = bad[flip][:100] + bytes([bad[flip][100] ^ 1]) + bad[flip][101:]
    t0 = time.perf_counter()
    vres = vp.verify_chunks(bad, step_digests)
    verify_s = time.perf_counter() - t0
    check(vres.corrupt == [flip] and vres.checked == len(step_chunks),
          f"verify_chunks: corrupt {vres.corrupt}, want [{flip}]")
    del bad
    n0 = names[0]
    t0 = time.perf_counter()
    vs = vp.verify_stream(streams[n0], ref_bounds[n0], ref_digests[n0])
    verify_stream_s = time.perf_counter() - t0
    check(vs.ok and vs.checked == len(ref_bounds[n0]), "verify_stream of one stream")
    snap = step_chunks[:VERIFY_SNAPSHOT_CHUNKS]
    snap_digests = step_digests[:VERIFY_SNAPSHOT_CHUNKS]
    wrong, unreadable = 5, 17
    held = dict(zip(snap_digests, snap))
    held[snap_digests[wrong]] = snap[wrong][:-1] + bytes([snap[wrong][-1] ^ 1])

    class Index:
        def __init__(self, digests):
            self.ends = list(range(len(digests)))
            self._d = digests

        def digest(self, i):
            return self._d[i]

    class Reader:
        """A snapshot without per-entry digests: chunk-level verify."""
        meta_index = Index([])
        payload_index = Index(snap_digests)

        def entries(self):
            return []

        def fetch_chunk(self, d):
            if d == snap_digests[unreadable]:
                raise OSError("unreadable chunk")
            return held[d]

    verdicts = [vp.verify_snapshot(Reader(), workers=w) for w in (0, 4)]
    # on the card every fetched chunk is re-hashed by K2, which catches the
    # wrong bytes; on the CPU (a rehearsal) the fetch alone is the verdict
    want_corrupt = sorted([wrong, unreadable]) if dev.type == "cuda" \
        else [unreadable]
    for v in verdicts:
        check(sorted(v.corrupt) == want_corrupt and v.checked == len(snap),
              f"verify_snapshot: corrupt {v.corrupt}, want {want_corrupt}")
    check(verdicts[0].corrupt == verdicts[1].corrupt
          and verdicts[0].corrupt_paths == verdicts[1].corrupt_paths,
          "verify_snapshot verdicts differ between 0 and 4 workers")
    verify_launches = {"sha256_chunks": sha256.KERNEL.launches}
    check(verify_launches["sha256_chunks"] > 0, "K2 did not launch on the verify path")
    emit({"phase": "verify", "chunks": len(step_chunks), "corrupt": vres.corrupt,
          "verify_chunks_s": verify_s, "verify_stream_s": verify_stream_s,
          "snapshot_chunks": len(snap), "snapshot_corrupt": verdicts[0].corrupt,
          "launches": verify_launches})

    # 10. fold fingerprint ---------------------------------------------------
    fingerprint.stats["fold_fingerprint"] = 0
    st_np = np.array([s for s, _ in step_bounds], dtype=np.int64)
    ln_np = np.array([e - s for s, e in step_bounds], dtype=np.int64)
    fp_t_max = int(ln_np.max() + 63) // 64
    t0 = time.perf_counter()
    fold = fingerprint.fold_fingerprint(dstream, st_np, ln_np, fp_t_max, device=dev)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    fold_launches = dict(fingerprint.stats)
    check(fold_launches["fold_fingerprint"] > 0, "fold_fingerprint did not run")
    fp_idx = np.linspace(0, len(step_chunks) - 1, FP_SAMPLE).astype(int)
    fold_np = fold.cpu().numpy().astype(np.uint32)
    t0 = time.perf_counter()
    fp_host = [fingerprint.fold_fingerprint_host(step_chunks[i]) for i in fp_idx]
    fold_plain_ms = (time.perf_counter() - t0) * 1e3
    check([fold_np[i].astype(">u4").tobytes() for i in fp_idx] == fp_host,
          "fold_fingerprint != fold_fingerprint_host")
    emit({"phase": "fingerprint", "chunks": len(step_bounds), "t_max": fp_t_max,
          "seconds": fold_s, "launches": fold_launches, "host_checked": FP_SAMPLE})

    # 11. fused ingest ---------------------------------------------------------
    # each stream's next window after its first segment, with its real
    # 63-byte tail, as 4 blocks; one K1 launch over the packed buffer
    w_off = min(seg, STREAM_BYTES - INGEST_WINDOW)
    rows, tails = [], []
    for n in names:
        win = memoryview(streams[n][w_off:w_off + INGEST_WINDOW])
        q = INGEST_WINDOW // 4
        rows.append([win[i * q:(i + 1) * q if i < 3 else INGEST_WINDOW]
                     for i in range(4)])
        tails.append(streams[n][w_off - WINDOW + 1:w_off].tobytes())
    batch = ingest.pack_rows(rows, tails, [WINDOW - 1] * N_STREAMS,
                             [w_off] * N_STREAMS)
    rolling_hash.KERNEL.launches = 0
    sha256.KERNEL.launches = 0
    stats0 = dict(ingest.stats)
    t0 = time.perf_counter()
    ends = ingest.scan_rows(batch, P, device=dev)
    scan_s = time.perf_counter() - t0
    ing_chunks = []
    win_plain = []      # plain K1's hits in each window, for phase 12's fan-in
    for n, e in zip(names, ends):
        win = torch.from_numpy(streams[n][w_off:w_off + INGEST_WINDOW].copy()).to(dev)
        tail = torch.from_numpy(streams[n][w_off - WINDOW + 1:w_off].copy()).to(dev)
        want = rolling_hash.candidate_mask_plain(win[None], tables, P.mask, P.magic,
                                                 tail[None])
        win_plain.append(torch.nonzero(want[0]).flatten().cpu().numpy())
        check(np.array_equal(e, win_plain[-1] + 1 + w_off),
              f"scan_rows of {n} != plain K1 in stream context")
        cuts = select_cuts(e, w_off + INGEST_WINDOW, P, start=w_off)
        for s, c in zip([w_off] + cuts[:-1], cuts):
            ing_chunks.append(streams[n][s:c].tobytes())
    t0 = time.perf_counter()
    ing_digests = ingest.digest_chunks(ing_chunks, device=dev)
    digest_s = time.perf_counter() - t0
    ing_launches = {"candidate_mask": rolling_hash.KERNEL.launches,
                    "sha256_chunks": sha256.KERNEL.launches}
    check(ing_launches["candidate_mask"] == 1 and ing_launches["sha256_chunks"] > 0,
          f"ingest launches: {ing_launches}")
    check(ing_digests == [hashlib.sha256(c).digest() for c in ing_chunks],
          "digest_chunks != hashlib")
    emit({"phase": "ingest", "rows": N_STREAMS, "window": INGEST_WINDOW,
          "packed_bytes": len(batch.buf), "padding_bytes": batch.padding_bytes,
          "candidates": int(sum(len(e) for e in ends)), "chunks": len(ing_chunks),
          "scan_s": scan_s, "scan_mib_s": len(batch.buf) / 2**20 / scan_s,
          "digest_s": digest_s, "launches": ing_launches,
          "stats": {k: ingest.stats[k] - stats0[k] for k in ingest.stats}})
    del rows, batch, ing_chunks

    # 12. the multi-device layer -------------------------------------------
    par, par_nums = parallel_phase(dev, P, streams, dstream, step_bounds,
                                   step_digests, index, pre, w_off, win_plain,
                                   args.seed)
    emit(par)

    # 13-15. the store's index tier ---------------------------------------
    ix = index_phase(dev, args.seed)
    emit(ix)
    emit(dist_index_phase(dev, args.seed))
    emit(similarity_index_phase(dev, step_chunks, step_digests, args.seed))

    # 16. timings at the main path's shapes ----------------------------------
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

    # the torch-op programs of this run's paths, on device-resident inputs
    def bound(nbytes, ops, rate):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    da = torch.from_numpy(sim_a.copy()).to(dev)
    proj64 = torch.from_numpy(similarity.simhash_projection(64).astype(np.float64)).to(dev)
    sh_ms = cuda_ms(lambda: similarity._simhash(da, proj64, 64), 5)
    sh_bound = bound(da.numel() + SIM_DIGESTS * 8, 2 * SIM_DIGESTS * 256 * 64, FP64_FLOPS)
    mh_a, mh_b = similarity._minhash_params(128, 99)
    mh_a = torch.from_numpy(mh_a.astype(np.int64)).to(dev)
    mh_b = torch.from_numpy(mh_b.astype(np.int64)).to(dev)
    mh_ms = cuda_ms(lambda: similarity._minhash(da, mh_a, mh_b), 5)
    mh_bound = bound(da.numel() + 128 * 4, MINHASH_OPS * SIM_DIGESTS * 128, int32_ops_per_s)
    ska = torch.from_numpy(sk_a.astype(np.int64)).to(dev)
    skb = torch.from_numpy(sk_b.astype(np.int64)).to(dev)
    ham_ms = cuda_ms(lambda: similarity.pairwise_hamming(ska, skb), 3)
    ham_corner_ms = cuda_ms(lambda: similarity.pairwise_hamming(
        ska[:SIM_CORNER], skb[:SIM_CORNER]), 5)
    # the library's one call for the same distances: torch.cdist with p=0
    # (the count of differing coordinates) over the sketches' unpacked bits
    shifts = torch.arange(32, device=dev)
    bits_a = ((ska[:, :, None] >> shifts) & 1).reshape(len(ska), -1).float()
    bits_b = ((skb[:, :, None] >> shifts) & 1).reshape(len(skb), -1).float()
    check(torch.equal(torch.cdist(bits_a, bits_b, p=0).to(torch.int64),
                      similarity.pairwise_hamming(ska, skb).to(torch.int64)),
          "torch.cdist(p=0) on the unpacked bits != pairwise_hamming")
    ham_lib_ms = cuda_ms(lambda: torch.cdist(bits_a, bits_b, p=0), 3)
    del bits_a, bits_b
    # both [10k, 2] word inputs read once, the [10k, 10k] int32 matrix written
    ham_bound = bound(4 * (2 * 2 * SIM_DIGESTS + SIM_DIGESTS ** 2),
                      HAMMING_OPS * 2 * SIM_DIGESTS ** 2, int32_ops_per_s)
    cs_lens = np.array([max(4, len(c)) for c in step_chunks], dtype=np.int64)
    cs_groups = []
    for g in length_groups(cs_lens, similarity.GROUP_ELEMS):
        padded = torch.zeros((len(g), int(cs_lens[g].max())), dtype=torch.uint8,
                             device=dev)
        for r, i in enumerate(g):
            s_, e_ = step_bounds[i]
            padded[r, :e_ - s_] = dstream[s_:e_]
        cs_groups.append((padded, torch.from_numpy(cs_lens[g]).to(dev)))
    cs_ms = cuda_ms(lambda: [similarity._content_sketch_words(p_, l_)
                             for p_, l_ in cs_groups], 3)
    cs_top = top(device_ms(lambda: [similarity._content_sketch_words(p_, l_)
                                    for p_, l_ in cs_groups])[1], 6)
    del cs_groups
    cs_sample_ms = cuda_ms(lambda: similarity.content_sketch_device(cs_sample, device=dev), 3)
    step_bytes = int(ln_np.sum())
    cs_bound = bound(step_bytes + 8 * len(step_chunks), CS_OPS_PER_BYTE * step_bytes,
                     int32_ops_per_s)
    fold_ms = cuda_ms(lambda: fingerprint.fold_fingerprint(dstream, st_np, ln_np,
                                                           fp_t_max), 3)
    fold_bound = bound(step_bytes + 32 * len(step_chunks), FOLD_OPS_PER_BYTE * step_bytes,
                       int32_ops_per_s)
    fold_sample_ms = cuda_ms(lambda: fingerprint.fold_fingerprint(
        dstream, st_np[fp_idx], ln_np[fp_idx], fp_t_max), 3)
    emit({"phase": "torch_ops_profile", "card": card,
          "content_sketch_top_device_ms": cs_top,
          "fold_fingerprint_top_device_ms": top(device_ms(
              lambda: fingerprint.fold_fingerprint(dstream, st_np, ln_np, fp_t_max))[1], 6),
          "pairwise_hamming_top_device_ms": top(device_ms(
              lambda: similarity.pairwise_hamming(ska, skb))[1], 6)})

    def op_row(name, source, replaces, launches, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": "torch", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": 0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None, **extra}

    sim_src = "pbs_plus_tpu_torch/ops/similarity.py"
    # the sequence-parallel mask reads the 2 GiB stream and writes its mask;
    # the step is K1 over the same bytes, then K2's chain on each 4 MiB head:
    # a launch's heads run side by side, but the launches of the data shards
    # that share a card queue one after another on it
    sp_bound = bound(2 * N_STREAMS * STREAM_BYTES, K1_OPS_PER_BYTE
                     * N_STREAMS * STREAM_BYTES, int32_ops_per_s)
    head_floor_ms = ((STEP_CHUNK + 8) // 64 + 1) * 64 * K2_ROUND_FLOOR_CYCLES \
        / clock_hz * 1e3
    step_bound = (par_nums["step"]["shards_per_card"] * head_floor_ms
                  + sp_bound[0], "operations")
    emit({"torch_ops": [
        {"name": "cuckoo_probe", "route": "torch",
         "source": "pbs_plus_tpu_torch/ops/cuckoo.py",
         "replaces": "pbs_plus_tpu/ops/cuckoo.py:87",
         "launches": main_launches["cuckoo_probe"], "max_abs_err": 0,
         "ms": k3_ms, "plain_ms": k3_ms, "bound_ms": k3_bound,
         "bound_by": "bytes", "library_ms": k3_ms,
         "fused_ingest_launches": fused["launches"]["cuckoo_probe"],
         "store_launches": store_launches["cuckoo_probe"],
         "tape_launches": tape_line["launches"]["cuckoo_probe"],
         "fleet_launches": fleet_line["launches"]["cuckoo_probe"],
         "mount_launches": mount_line["launches"]["cuckoo_probe"],
         "backup_job_launches": job_line["launches"]["cuckoo_probe"],
         "server_launches": server_line["launches"]["cuckoo_probe"],
         "sync_launches": sync_line["launches"]["cuckoo_probe"],
         "kinds_launches": kinds_line["launches"]["cuckoo_probe"],
         "web_launches": web_line["launches"]["cuckoo_probe"],
         "index": {"launches": ix["k3_launches"],
                   "table_bytes": INDEX_BUDGET_MB << 20,
                   "batch_ms": ix["k3_ms"],
                   "uploads": ix["uploads"]}},
        op_row("simhash", sim_src, "pbs_plus_tpu/ops/similarity.py:56",
               sim_launches["simhash"], sh_ms, sh_plain_ms, sh_bound,
               shape=[SIM_DIGESTS, 64]),
        op_row("minhash", sim_src, "pbs_plus_tpu/ops/similarity.py:103",
               sim_launches["minhash"], mh_ms, mh_plain_ms, mh_bound,
               shape=[SIM_DIGESTS, 128]),
        op_row("pairwise_hamming", sim_src, "pbs_plus_tpu/ops/similarity.py:89",
               sim_launches["pairwise_hamming"], ham_ms, ham_plain_ms, ham_bound,
               shape=[SIM_DIGESTS, SIM_DIGESTS, 2],
               plain_shape=f"{SIM_CORNER} x {SIM_CORNER} corner, "
                           f"torch {ham_corner_ms} ms there",
               library_ms=ham_lib_ms,
               library_call="torch.cdist(p=0) on the [10k, 64] unpacked "
                            "bits, float32"),
        op_row("content_sketch", sim_src, "pbs_plus_tpu/ops/similarity.py:255",
               sim_launches["content_sketch"], cs_ms, cs_plain_ms, cs_bound,
               shape=f"{len(step_chunks)} chunks, {step_bytes} bytes",
               ms_with_upload=cs_s * 1e3,
               plain_shape=f"{CS_SAMPLE} of the chunks, torch {cs_sample_ms} ms "
                           "there with the upload"),
        op_row("fold_fingerprint", "pbs_plus_tpu_torch/ops/fingerprint.py",
               "pbs_plus_tpu/ops/fingerprint.py:24",
               fold_launches["fold_fingerprint"], fold_ms, fold_plain_ms, fold_bound,
               shape=f"{len(step_chunks)} chunks, {step_bytes} bytes",
               plain_shape=f"{FP_SAMPLE} of the chunks, torch {fold_sample_ms} ms there"),
        # the multi-device programs (phase 12), at its shapes
        op_row("probe_local", "pbs_plus_tpu_torch/parallel/dist_index.py",
               "pbs_plus_tpu/parallel/dist_index.py:62",
               par_nums["step"]["launches"]["probe_local"],
               par_nums["probe_local"]["ms"], par_nums["probe_local"]["ms"],
               bound(PAR_PROBE_BATCH * (32 + 2 * cuckoo.BUCKET_BYTES + 1), 0,
                     int32_ops_per_s),
               shape=f"{PAR_PROBE_BATCH} digests over "
                     f"{par_nums['probe_local']['shards']} index shards",
               sharded_index_launches=par_nums["probe_local"]["launches"],
               plain_shape="the ops are the plain version"),
        op_row("step_simhash", sim_src, "pbs_plus_tpu/parallel/sharded_step.py:56",
               par_nums["step"]["launches"]["simhash"],
               par_nums["step"]["layers"]["simhash_ms"],
               par_nums["simhash_host_ms"],
               bound(N_STREAMS * (32 + 8), 2 * N_STREAMS * 256 * 64, FP64_FLOPS),
               shape=[N_STREAMS, 64], plain_shape="numpy twin"),
        op_row("sp_mask_local", "pbs_plus_tpu_torch/parallel/sp_chunker.py",
               "pbs_plus_tpu/parallel/sp_chunker.py:25",
               par_nums["sp"]["launches"], par_nums["sp"]["ms"],
               par_nums["sp"]["plain_ms"], sp_bound,
               shape=f"{N_STREAMS * STREAM_BYTES} bytes over {SEQ_SHARDS} shards",
               one_device_k1_ms=par_nums["sp"]["one_ms"]),
        op_row("step_body", "pbs_plus_tpu_torch/parallel/sharded_step.py",
               "pbs_plus_tpu/parallel/sharded_step.py:39",
               par_nums["step"]["launches"]["candidate_mask"],
               par_nums["step"]["ms"], None, step_bound,
               shape=f"{N_STREAMS} x {STREAM_BYTES} bytes, heads of "
                     f"{STEP_CHUNK}, {PAR_DATA} x {PAR_INDEX} mesh",
               bound_parts={"k2_head_chain_ms": head_floor_ms,
                            "data_shards_per_card":
                                par_nums["step"]["shards_per_card"],
                            "k1_bytes_ms": sp_bound[0]},
               layers=par_nums["step"]["layers"],
               plain_k1_layer_ms=par_nums["step"]["k1_plain_ms"],
               plain_shape="K1 layer only: the plain SHA-256 steps once per "
                           f"64-byte block, {(STEP_CHUNK + 8) // 64 + 1:,} "
                           "a head"),
    ]})

    # 17. the kernels line ---------------------------------------------------
    emit({"kernels": [
        {"name": "candidate_mask", "route": "cuda",
         "source": "pbs_plus_tpu_torch/ops/csrc/rolling_hash.cu",
         "replaces": "pbs_plus_tpu/ops/pallas_rolling_hash.py:69",
         "launches": main_launches["candidate_mask"],
         "launches_by_path": {
             "main": main_launches["candidate_mask"],
             "parallel_step": par_nums["step"]["launches"]["candidate_mask"],
             "sequence_parallel": par_nums["sp"]["launches"],
             "fan_in": par_nums["fan_in"]["k1"],
             "fused_ingest": fused["launches"]["candidate_mask"],
             "store": store_launches["candidate_mask"],
             "tape": tape_line["launches"]["candidate_mask"],
             "fleet": fleet_line["launches"]["candidate_mask"],
             "mount": mount_line["launches"]["candidate_mask"],
             "backup_job": job_line["launches"]["candidate_mask"],
             "server": server_line["launches"]["candidate_mask"],
             "kinds": kinds_line["launches"]["candidate_mask"],
             "web": web_line["launches"]["candidate_mask"]},
         "max_abs_err": int(k1_err > 0),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bound_bytes >= k1_bound_ops else "operations",
         "library_ms": None},
        {"name": "sha256_chunks", "route": "cuda",
         "source": "pbs_plus_tpu_torch/ops/csrc/sha256.cu",
         "replaces": "pbs_plus_tpu/ops/sha256.py:120",
         "launches": main_launches["sha256_chunks"],
         "launches_by_path": {
             "main": main_launches["sha256_chunks"],
             "parallel_step": par_nums["step"]["launches"]["sha256_chunks"],
             "fan_in": par_nums["fan_in"]["k2"],
             "fused_ingest": fused["launches"]["sha256_chunks"],
             "store": store_launches["sha256_chunks"],
             "tape": tape_line["launches"]["sha256_chunks"],
             "fleet": fleet_line["launches"]["sha256_chunks"],
             "verification": ver_launches,
             "mount": mount_line["launches"]["sha256_chunks"],
             "backup_job": job_line["launches"]["sha256_chunks"],
             "server": server_line["launches"]["sha256_chunks"],
             "kinds": kinds_line["launches"]["sha256_chunks"],
             "web": web_line["launches"]["sha256_chunks"]},
         "max_abs_err": k2_err,
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
