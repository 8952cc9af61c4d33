"""PyTorch and CUDA port of the pbs-plus-tpu dedup data plane.

The JAX package ``pbs_plus_tpu`` is the reference; this package imports
torch, numpy and the standard library, never JAX and never the reference.
Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
asked for and absent; the tests pass ``device="cpu"``, which runs each
kernel's plain PyTorch version.

- ops: K1 candidate mask and K2 SHA-256 (CUDA C++ for sm_90a, built at
  first use), K3 cuckoo probe in PyTorch ops; fused ragged ingest on K1
  and K2; similarity sketches and the fold fingerprint in PyTorch ops.
- models: DedupPipeline (whole streams), CudaChunker + DeviceFeeder
  (streaming writers), the ``"cuda"`` backend factories, VerifyPipeline,
  SimilarityModel.
- sidecar: the dedup sidecar's gRPC service (DedupService,
  serve_sidecar) and its client (SidecarClient with its breaker and
  retries, SidecarChunker, the ResilientSidecarFactory of a
  ``"sidecar:<host:port>"`` row); ``python -m pbs_plus_tpu_torch
  sidecar`` runs the service.
- chunker: the spec, the scan counters and the host chunker kinds of a
  ``cpu``/``scalar``/``vector`` row (CpuChunker, the g++-built native
  scan, VectorChunker and ResilientVectorFactory): host code, no kernel.
- pxar: the store's dedup-index tier -- DedupIndex (the ``index=`` of a
  JAX ``ChunkStore``; K3 on the card), the spillable DigestLog and the
  delta tier's SimilarityIndex; snapshots, segments and manifests are
  byte-identical to the JAX package's.  And the store's fused-ingest
  write path: IngestCollector (one K1 launch and one K2 batch per flush
  across every concurrent writer), FusedIngestStream and collector_for.
- parallel: device meshes (``make_mesh``, ``make_seq_mesh``, the
  process's ``data_mesh`` under the batched K1/K2 dispatches), the
  multi-device dedup step, sequence-parallel chunking and the
  index-sharded ``ShardedCuckooIndex``, one process driving every device;
  ``python -m pbs_plus_tpu_torch dryrun-multichip`` runs them once.  Also
  the distributed index's service half (ShardMap, IndexShardServer,
  DistIndexClient) on the JAX package's HTTP wire; ``python -m
  pbs_plus_tpu_torch index-shard`` runs one shard node.
- pxar (the store): LocalStore (backups on K1, K2 and K3 on its device),
  SplitReader, ChunkStore/Datastore, copies of the JAX package's with
  byte-identical snapshots.
- server: the verification job (``run_verification``,
  ``enqueue_verification``; K2 re-hashes stored snapshots), with copies
  of the job record and the task UPID (``proxmox``) it uses; the agent
  backup job (``backup_job.run_target_backup``: agent, local and s3
  targets into a LocalStore, whose device runs K1, K2 and K3), with the
  database, checkpoints and the S3 source.
- arpc, agent: the aRPC fabric (mux, calls, router, the mTLS transport
  and its plain loopback mode, AgentsManager) and the agent (agentfs,
  snapshots, drives, AgentLifecycle with the handlers a backup job
  calls), copies of the JAX package's.
- mount: the mount stack (copies of the JAX package's ``Journal``,
  ``ArchiveView``, ``MutableFS``, control socket and libfuse frontend) and
  ``CommitEngine(device=)``, which commits a mutated mount as a new
  snapshot: the store cuts (K1), digests (K2) and probes (K3), and the
  engine re-verifies the changed files on K2.  ``python -m
  pbs_plus_tpu_torch mount`` / ``commit`` run it; ``server.mount_service``
  spawns the former.  ``pxar.pbsstore.PBSStore(device=)`` commits to a
  PBS server over its wire protocol.
- server (the daemon): the web API (``server/web.py``: job, target,
  restore, verification, snapshot and agent routes, PBS ticket auth,
  ``/plus/metrics``), notifications and the alert scanner, the restore
  job (the agent pulls the snapshot over ``pxar/remote.py``), and the
  agent's job children (``agent/jobproc.py``); ``python -m
  pbs_plus_tpu_torch server`` / ``agent`` / ``agent-job`` run them.
  Datastore replication (``pxar/syncwire.py``, ``server/sync_job.py``):
  dedup-aware, resumable sync local to local or over its HTTP wire,
  membership batches probed by the destination's index (K3 on the card).
  The agent's registry and self-update (``agent/{registry,updater}.py``)
  and ``python -m pbs_plus_tpu_torch signer``.
- tapeio: MTF/BKF media into a store session (``convert_mtf_to_snapshot``
  on the store's device: K1, K2, K3), the spool, the cartridge inventory,
  LTO drives and the media changer; ``python -m pbs_plus_tpu_torch
  mtfprobe``.  agent.win: the Windows agent seams (ACLs and security
  descriptors, registry, drives, VSS, the NT service, restore metadata).
  operator: the Kubernetes operator (``python -m
  pbs_plus_tpu_torch.operator``).  proxmox: PBS task logs and the
  management API client.  utils: lockwatch, memlimit, safemap.  Copies of
  the JAX package's.
- convert: index and chunker state carried across from the JAX package.
"""

from .chunker.spec import (DEFAULT_PARAMS, TEST_PARAMS, WINDOW,
                           ChunkerParams, select_cuts)
from .ops import (HALO, CuckooIndex, RaggedBatch, buckets_for_bytes,
                  candidate_ends_host, candidate_mask, content_sketch_device,
                  content_sketch_host, digest_chunks, fold_fingerprint,
                  fold_fingerprint_host, lookup_host, minhash_signature,
                  minhash_signature_host, minhash_similarity, pack_rows,
                  pairwise_hamming, pairwise_hamming_host, scan_rows,
                  sha256_chunks, sha256_stream_chunks, simhash_projection,
                  simhash_sketch, simhash_sketch_host, sketch_hamming)
from .models import (ChunkRecord, CudaChunker, DedupConfig, DedupPipeline,
                     DeviceFeeder, SimilarityModel, StreamResult,
                     VerifyPipeline, VerifyResult, get_feeder,
                     make_batch_hasher, make_chunker_factory)
from .sidecar import DedupService, SidecarClient, serve_sidecar
from .pxar import (ChunkStore, Datastore, DedupIndex, DigestLog,
                   FusedIngestStream, IngestCollector, LocalStore,
                   SimilarityIndex, SplitReader, collector_for)
from .server.verification_job import enqueue_verification, run_verification
from .mount import ArchiveView, CommitEngine, Journal, MutableFS
from .pxar.pbsstore import PBSConfig, PBSStore
from .parallel import (DistIndexClient, IndexShardServer, ShardedCuckooIndex,
                       ShardMap, make_mesh, make_seq_mesh,
                       multichip_dedup_step, sp_chunk_stream)
from .convert import (index_from_reference, params_from_reference,
                      sharded_index_from_reference)

__all__ = [
    "DEFAULT_PARAMS", "TEST_PARAMS", "WINDOW", "ChunkerParams", "select_cuts",
    "candidate_mask", "candidate_ends_host",
    "sha256_chunks", "sha256_stream_chunks",
    "CuckooIndex", "buckets_for_bytes", "lookup_host",
    "DedupPipeline", "DedupConfig", "StreamResult", "ChunkRecord",
    "CudaChunker", "DeviceFeeder", "get_feeder",
    "make_chunker_factory", "make_batch_hasher",
    "HALO", "RaggedBatch", "pack_rows", "scan_rows", "digest_chunks",
    "simhash_projection", "simhash_sketch", "simhash_sketch_host",
    "pairwise_hamming", "pairwise_hamming_host",
    "minhash_signature", "minhash_signature_host", "minhash_similarity",
    "content_sketch_device", "content_sketch_host", "sketch_hamming",
    "fold_fingerprint", "fold_fingerprint_host",
    "VerifyPipeline", "VerifyResult", "SimilarityModel",
    "DedupService", "serve_sidecar", "SidecarClient",
    "DedupIndex", "DigestLog", "SimilarityIndex",
    "IngestCollector", "FusedIngestStream", "collector_for",
    "LocalStore", "ChunkStore", "Datastore", "SplitReader",
    "run_verification", "enqueue_verification",
    "ArchiveView", "CommitEngine", "Journal", "MutableFS",
    "PBSConfig", "PBSStore",
    "DistIndexClient", "IndexShardServer", "ShardMap",
    "make_mesh", "make_seq_mesh", "multichip_dedup_step", "sp_chunk_stream",
    "ShardedCuckooIndex",
    "index_from_reference", "params_from_reference",
    "sharded_index_from_reference",
]
