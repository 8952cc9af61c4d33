"""Input validation helpers (reference: internal/validate).

A copy of the JAX package's ``utils/validate.py``, its code byte for
byte apart from its imports, which name the port's own modules."""

from __future__ import annotations

import re

# job ids / datastore names: DB + UPID keys, never path components —
# leading underscore stays valid (grandfathered)
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9._:\-]*$")
# names that become datastore path components (backup id, target name,
# rfc3339 time): leading char alphanumeric, then alphanumerics plus
# ._:- — one alphabet for mint AND parse time so no unreachable
# snapshot can be created
_COMPONENT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:\-]*$")
_HOSTNAME_RE = re.compile(
    r"^(?=.{1,253}$)([a-zA-Z0-9](?:[a-zA-Z0-9\-]{0,61}[a-zA-Z0-9])?\.)*"
    r"[a-zA-Z0-9](?:[a-zA-Z0-9\-]{0,61}[a-zA-Z0-9])?$"
)


class ValidationError(ValueError):
    pass


def job_id(value: str) -> str:
    if not value or len(value) > 256 or not _NAME_RE.match(value):
        raise ValidationError(f"invalid job id {value!r}")
    return value


def hostname(value: str) -> str:
    if not value or not _HOSTNAME_RE.match(value):
        raise ValidationError(f"invalid hostname {value!r}")
    return value


def datastore_name(value: str) -> str:
    if not value or len(value) > 128 or not _NAME_RE.match(value):
        raise ValidationError(f"invalid datastore name {value!r}")
    return value


def snapshot_component(value: str) -> str:
    """A single snapshot-path segment (backup id, target name, rfc3339
    time): must be safe as a path component AND as subprocess argv."""
    if not value or len(value) > 256 or not _COMPONENT_RE.match(value):
        raise ValidationError(f"invalid name component {value!r}")
    return value


MAX_NAMESPACE_DEPTH = 7     # PBS's own limit; THE constant — datastore's
                            # parser re-exports it so mint-time and
                            # parse-time limits cannot diverge


def namespace_path(value: str) -> str:
    """A PBS-style namespace ("a/b/c"): each segment a safe component,
    bounded depth.  Empty = root namespace."""
    if not value:
        return value
    parts = value.split("/")
    if len(parts) > MAX_NAMESPACE_DEPTH:
        raise ValidationError(f"namespace too deep: {value!r}")
    for p in parts:
        snapshot_component(p)
    return value


def safe_rel_path(value: str) -> str:
    """Reject traversal / absolute components in archive-relative paths."""
    if value.startswith("/") or "\x00" in value:
        raise ValidationError(f"unsafe path {value!r}")
    parts = value.split("/")
    if any(p in ("", ".", "..") for p in parts):
        raise ValidationError(f"unsafe path {value!r}")
    return value
