"""The agent side of the port (reference: internal/agent + cmd/agent).

Copies of the JAX package's ``agent/agentfs.py`` (the read-only remote-FS
protocol a backup job walks), ``agent/snapshots.py`` (btrfs, zfs, lvm,
freeze and direct snapshots), ``agent/drives.py`` (volume inventory) and
``agent/lifecycle.py`` (the control-plane session and the handlers the
backup job calls).  The agent does no device work: it serves files.
"""
