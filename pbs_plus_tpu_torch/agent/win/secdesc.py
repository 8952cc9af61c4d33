"""Windows security-descriptor codec: self-relative binary
SECURITY_DESCRIPTOR ⇄ SDDL ⇄ structured ACE list — pure Python, no
Windows required.

Reference parity: internal/agent/agentfs/acls_windows.go:1-310 captures
(owner SID, group SID, []WinACL{SID, AccessMask, Type, Flags}) from live
handles via advapi32; internal/pxar/restore_windows.go re-applies them.
This build captures SDDL via the PowerShell seam (``acls.py``) — this
module adds the structured layer those APIs expose natively: parse the
binary descriptor (what BackupRead/GetSecurityInfo emit), walk typed
ACEs, and convert losslessly to/from SDDL.  On a real Windows host the
agent can then carry the native binary SD in the archive
(``win.sd`` xattr) and still render/inspect it anywhere.

Wire layouts implemented (all little-endian, [MS-DTYP]):

- SECURITY_DESCRIPTOR (self-relative): Revision u8, Sbz1 u8, Control
  u16, OffsetOwner u32, OffsetGroup u32, OffsetSacl u32, OffsetDacl u32
- SID: Revision u8, SubAuthorityCount u8, IdentifierAuthority u48 BE,
  SubAuthority u32 × count
- ACL: AclRevision u8, Sbz1 u8, AclSize u16, AceCount u16, Sbz2 u16
- ACE: AceType u8, AceFlags u8, AceSize u16, AccessMask u32, SID

A copy of the JAX package's ``agent/win/secdesc.py``, its code byte for
byte.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

# -- control bits ---------------------------------------------------------
SE_OWNER_DEFAULTED = 0x0001
SE_GROUP_DEFAULTED = 0x0002
SE_DACL_PRESENT = 0x0004
SE_DACL_DEFAULTED = 0x0008
SE_SACL_PRESENT = 0x0010
SE_SACL_DEFAULTED = 0x0020
SE_DACL_AUTO_INHERIT_REQ = 0x0100
SE_SACL_AUTO_INHERIT_REQ = 0x0200
SE_DACL_AUTO_INHERITED = 0x0400
SE_SACL_AUTO_INHERITED = 0x0800
SE_DACL_PROTECTED = 0x1000
SE_SACL_PROTECTED = 0x2000
SE_SELF_RELATIVE = 0x8000

# -- ACE types / flags ----------------------------------------------------
ACCESS_ALLOWED = 0x00
ACCESS_DENIED = 0x01
SYSTEM_AUDIT = 0x02
_ACE_TYPE_SDDL = {ACCESS_ALLOWED: "A", ACCESS_DENIED: "D",
                  SYSTEM_AUDIT: "AU"}
_SDDL_ACE_TYPE = {v: k for k, v in _ACE_TYPE_SDDL.items()}

OBJECT_INHERIT_ACE = 0x01
CONTAINER_INHERIT_ACE = 0x02
NO_PROPAGATE_INHERIT_ACE = 0x04
INHERIT_ONLY_ACE = 0x08
INHERITED_ACE = 0x10
SUCCESSFUL_ACCESS_ACE = 0x40
FAILED_ACCESS_ACE = 0x80
_ACE_FLAG_SDDL = [(OBJECT_INHERIT_ACE, "OI"), (CONTAINER_INHERIT_ACE, "CI"),
                  (NO_PROPAGATE_INHERIT_ACE, "NP"), (INHERIT_ONLY_ACE, "IO"),
                  (INHERITED_ACE, "ID"), (SUCCESSFUL_ACCESS_ACE, "SA"),
                  (FAILED_ACCESS_ACE, "FA")]

# -- access-mask SDDL aliases (file rights) -------------------------------
_RIGHTS_SDDL = [
    ("GA", 0x10000000), ("GR", 0x80000000), ("GW", 0x40000000),
    ("GX", 0x20000000),
    ("FA", 0x001F01FF), ("FR", 0x00120089), ("FW", 0x00120116),
    ("FX", 0x001200A0),
    ("KA", 0x000F003F), ("KR", 0x00020019), ("KW", 0x00020006),
    ("RC", 0x00020000), ("SD", 0x00010000), ("WD", 0x00040000),
    ("WO", 0x00080000),
]
_SDDL_RIGHTS = dict((k, v) for k, v in _RIGHTS_SDDL)

# -- well-known SID aliases ([MS-DTYP] 2.4.2.4 subset) --------------------
_SID_ALIASES = {
    "WD": "S-1-1-0",        # Everyone
    "CO": "S-1-3-0",        # Creator Owner
    "CG": "S-1-3-1",        # Creator Group
    "NU": "S-1-5-2",        # Network logon
    "IU": "S-1-5-4",        # Interactive
    "SU": "S-1-5-6",        # Service
    "AN": "S-1-5-7",        # Anonymous
    "ED": "S-1-5-9",        # Enterprise DCs
    "PS": "S-1-5-10",       # Principal Self
    "AU": "S-1-5-11",       # Authenticated Users
    "RC": "S-1-5-12",       # Restricted Code
    "SY": "S-1-5-18",       # Local System
    "LS": "S-1-5-19",       # Local Service
    "NS": "S-1-5-20",       # Network Service
    "BA": "S-1-5-32-544",   # Administrators
    "BU": "S-1-5-32-545",   # Users
    "BG": "S-1-5-32-546",   # Guests
    "PU": "S-1-5-32-547",   # Power Users
    "RD": "S-1-5-32-555",   # Remote Desktop Users
    "AC": "S-1-15-2-1",     # All Application Packages
}
_ALIAS_BY_SID = {v: k for k, v in _SID_ALIASES.items()}


# -- SID ------------------------------------------------------------------
def sid_to_bytes(sid: str) -> bytes:
    parts = sid.split("-")
    if len(parts) < 3 or parts[0] != "S":
        raise ValueError(f"bad SID string: {sid!r}")
    rev = int(parts[1])
    auth = int(parts[2])
    subs = [int(p) for p in parts[3:]]
    if len(subs) > 15:
        raise ValueError("too many SID sub-authorities")
    return (struct.pack("<BB", rev, len(subs))
            + auth.to_bytes(6, "big")
            + b"".join(struct.pack("<I", s) for s in subs))


def sid_from_bytes(raw: bytes, off: int = 0) -> tuple[str, int]:
    """Parse a SID at ``off``; returns (string form, bytes consumed)."""
    if len(raw) - off < 8:
        raise ValueError("truncated SID")
    rev, count = struct.unpack_from("<BB", raw, off)
    if rev != 1 or count > 15:
        raise ValueError(f"bad SID header rev={rev} count={count}")
    need = 8 + 4 * count
    if len(raw) - off < need:
        raise ValueError("truncated SID sub-authorities")
    auth = int.from_bytes(raw[off + 2:off + 8], "big")
    subs = struct.unpack_from(f"<{count}I", raw, off + 8) if count else ()
    return "S-1-" + "-".join(str(x) for x in (auth, *subs)), need


def _sid_sddl(sid: str) -> str:
    return _ALIAS_BY_SID.get(sid, sid)


_SID_RE = re.compile(r"S-1-\d+(-\d+)*\Z")


def _sid_unsddl(tok: str) -> str:
    if tok in _SID_ALIASES:
        return _SID_ALIASES[tok]
    if _SID_RE.fullmatch(tok):       # strictly numeric — canonicalization
        return tok                   # must never pass arbitrary text on
    raise ValueError(f"bad SID token {tok!r}")


# -- ACE / ACL ------------------------------------------------------------
@dataclass
class Ace:
    """Structured ACE — the types.WinACL parity surface."""
    type: int                    # ACCESS_ALLOWED / ACCESS_DENIED / AUDIT
    flags: int                   # inheritance/audit bits
    mask: int                    # access mask
    sid: str                     # S-1-... string form

    def to_bytes(self) -> bytes:
        sid = sid_to_bytes(self.sid)
        size = 8 + len(sid)
        return struct.pack("<BBHI", self.type, self.flags, size,
                           self.mask) + sid

    @classmethod
    def from_bytes(cls, raw: bytes, off: int) -> tuple["Ace", int]:
        atype, aflags, size, mask = struct.unpack_from("<BBHI", raw, off)
        if size < 8 or off + size > len(raw):
            raise ValueError("bad ACE size")
        sid, _ = sid_from_bytes(raw, off + 8)
        return cls(atype, aflags, mask, sid), size

    # SDDL ace string: (type;flags;rights;;;sid)
    def to_sddl(self) -> str:
        t = _ACE_TYPE_SDDL.get(self.type)
        if t is None:
            raise ValueError(f"ACE type {self.type} not SDDL-expressible")
        flags = "".join(s for bit, s in _ACE_FLAG_SDDL if self.flags & bit)
        rights = next((s for s, v in _RIGHTS_SDDL if v == self.mask),
                      f"0x{self.mask:x}")
        return f"({t};{flags};{rights};;;{_sid_sddl(self.sid)})"

    @classmethod
    def from_sddl(cls, s: str) -> "Ace":
        parts = s.strip("()").split(";")
        if len(parts) != 6:
            raise ValueError(f"bad ACE string {s!r}")
        t, flags_s, rights_s, objg, iobjg, sid_s = (p.strip().upper()
                                                    for p in parts)
        if objg or iobjg:
            raise ValueError("object ACEs not supported")
        if t not in _SDDL_ACE_TYPE:
            raise ValueError(f"ACE type {t!r} not supported")
        flags = 0
        for i in range(0, len(flags_s), 2):
            pair = flags_s[i:i + 2]
            bit = next((b for b, s2 in _ACE_FLAG_SDDL if s2 == pair), None)
            if bit is None:
                raise ValueError(f"unknown ACE flag {pair!r}")
            flags |= bit
        if rights_s.startswith("0X"):
            mask = int(rights_s, 16)
        else:
            mask = 0
            for i in range(0, len(rights_s), 2):
                pair = rights_s[i:i + 2]
                if pair not in _SDDL_RIGHTS:
                    raise ValueError(f"unknown rights token {pair!r}")
                mask |= _SDDL_RIGHTS[pair]
        return cls(_SDDL_ACE_TYPE[t], flags, mask, _sid_unsddl(sid_s))


@dataclass
class SecurityDescriptor:
    owner: str = ""
    group: str = ""
    control: int = SE_SELF_RELATIVE | SE_DACL_PRESENT
    dacl: list[Ace] = field(default_factory=list)
    sacl: list[Ace] = field(default_factory=list)
    # NULL DACL ≠ empty DACL: NULL means "no access control" (everyone
    # has full access); empty means "deny everyone".  SDDL spells the
    # former D:NO_ACCESS_CONTROL; conflating them would lock users out
    # of restored files that were legitimately wide open.
    null_dacl: bool = False

    # -- binary ----------------------------------------------------------
    def to_bytes(self) -> bytes:
        control = self.control | SE_SELF_RELATIVE
        if self.dacl or control & SE_DACL_PRESENT:
            control |= SE_DACL_PRESENT
        if self.sacl:
            control |= SE_SACL_PRESENT
        chunks: list[bytes] = []
        off = 20
        offs = {"owner": 0, "group": 0, "sacl": 0, "dacl": 0}

        def put(key: str, data: bytes):
            nonlocal off
            if data:
                offs[key] = off
                chunks.append(data)
                off += len(data)

        put("owner", sid_to_bytes(self.owner) if self.owner else b"")
        put("group", sid_to_bytes(self.group) if self.group else b"")
        if control & SE_SACL_PRESENT:
            put("sacl", _acl_bytes(self.sacl))
        if control & SE_DACL_PRESENT and not self.null_dacl:
            put("dacl", _acl_bytes(self.dacl))
        # null_dacl: DACL_PRESENT stays set with OffsetDacl == 0
        hdr = struct.pack("<BBHIIII", 1, 0, control, offs["owner"],
                          offs["group"], offs["sacl"], offs["dacl"])
        return hdr + b"".join(chunks)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SecurityDescriptor":
        if len(raw) < 20:
            raise ValueError("truncated security descriptor")
        rev, _, control, o_own, o_grp, o_sacl, o_dacl = \
            struct.unpack_from("<BBHIIII", raw, 0)
        if rev != 1:
            raise ValueError(f"unsupported SD revision {rev}")
        sd = cls(control=control, dacl=[], sacl=[])
        if o_own:
            sd.owner, _ = sid_from_bytes(raw, o_own)
        if o_grp:
            sd.group, _ = sid_from_bytes(raw, o_grp)
        if control & SE_DACL_PRESENT:
            if o_dacl:
                sd.dacl = _acl_parse(raw, o_dacl)
            else:
                sd.null_dacl = True       # present-but-NULL: everyone
        if control & SE_SACL_PRESENT and o_sacl:
            sd.sacl = _acl_parse(raw, o_sacl)
        return sd

    # -- SDDL ------------------------------------------------------------
    def to_sddl(self) -> str:
        out = []
        if self.owner:
            out.append(f"O:{_sid_sddl(self.owner)}")
        if self.group:
            out.append(f"G:{_sid_sddl(self.group)}")
        if self.control & SE_DACL_PRESENT or self.dacl or self.null_dacl:
            flags = ""
            if self.control & SE_DACL_PROTECTED:
                flags += "P"
            if self.control & SE_DACL_AUTO_INHERIT_REQ:
                flags += "AR"
            if self.control & SE_DACL_AUTO_INHERITED:
                flags += "AI"
            if self.null_dacl:
                # keep P/AR/AI: D:PNO_ACCESS_CONTROL is valid SDDL and
                # dropping SE_DACL_PROTECTED would change semantics on a
                # round-trip
                out.append(f"D:{flags}NO_ACCESS_CONTROL")
            else:
                out.append("D:" + flags
                           + "".join(a.to_sddl() for a in self.dacl))
        if self.control & SE_SACL_PRESENT or self.sacl:
            flags = ""
            if self.control & SE_SACL_PROTECTED:
                flags += "P"
            if self.control & SE_SACL_AUTO_INHERIT_REQ:
                flags += "AR"
            if self.control & SE_SACL_AUTO_INHERITED:
                flags += "AI"
            out.append("S:" + flags
                       + "".join(a.to_sddl() for a in self.sacl))
        return "".join(out)

    @classmethod
    def from_sddl(cls, sddl: str) -> "SecurityDescriptor":
        if not sddl or sddl[:2] not in ("O:", "G:", "D:", "S:"):
            # text before the first section is not SDDL — refuse rather
            # than silently producing an empty descriptor (untrusted
            # input guards in acls.apply depend on this)
            raise ValueError("not an SDDL string")
        sd = cls(control=SE_SELF_RELATIVE, dacl=[], sacl=[])
        for key, body in _sddl_sections(sddl):
            if key == "O":
                sd.owner = _sid_unsddl(body)
            elif key == "G":
                sd.group = _sid_unsddl(body)
            elif key in ("D", "S"):
                null_dacl = False
                if key == "D" and body.upper().endswith("NO_ACCESS_CONTROL"):
                    # ACL control flags may precede the token (D:P...)
                    body = body[:-len("NO_ACCESS_CONTROL")]
                    null_dacl = True
                flags, aces = _parse_acl_sddl(body)
                if null_dacl:
                    if aces:
                        raise ValueError("ACEs with NO_ACCESS_CONTROL")
                    sd.control |= SE_DACL_PRESENT
                    if "P" in flags:
                        sd.control |= SE_DACL_PROTECTED
                    if "AR" in flags:
                        sd.control |= SE_DACL_AUTO_INHERIT_REQ
                    if "AI" in flags:
                        sd.control |= SE_DACL_AUTO_INHERITED
                    sd.null_dacl = True
                    continue
                ctl = 0
                if "P" in flags:
                    ctl |= SE_DACL_PROTECTED if key == "D" \
                        else SE_SACL_PROTECTED
                if "AR" in flags:
                    ctl |= SE_DACL_AUTO_INHERIT_REQ if key == "D" \
                        else SE_SACL_AUTO_INHERIT_REQ
                if "AI" in flags:
                    ctl |= SE_DACL_AUTO_INHERITED if key == "D" \
                        else SE_SACL_AUTO_INHERITED
                sd.control |= ctl
                if key == "D":
                    sd.control |= SE_DACL_PRESENT
                    sd.dacl = aces
                else:
                    sd.control |= SE_SACL_PRESENT
                    sd.sacl = aces
        return sd


def _acl_bytes(aces: list[Ace]) -> bytes:
    body = b"".join(a.to_bytes() for a in aces)
    return struct.pack("<BBHHH", 2, 0, 8 + len(body), len(aces), 0) + body


def _acl_parse(raw: bytes, off: int) -> list[Ace]:
    rev, _, size, count, _ = struct.unpack_from("<BBHHH", raw, off)
    if rev not in (2, 4):
        raise ValueError(f"unsupported ACL revision {rev}")
    if off + size > len(raw):
        raise ValueError("ACL overruns descriptor")
    aces = []
    pos = off + 8
    for _ in range(count):
        ace, consumed = Ace.from_bytes(raw, pos)
        aces.append(ace)
        pos += consumed
    return aces


def _sddl_sections(sddl: str) -> list[tuple[str, str]]:
    """Split 'O:...G:...D:...S:...' into (key, body) pairs.  Section
    keys appear only at paren depth 0 — ACE bodies live inside parens."""
    out: list[tuple[str, str]] = []
    depth = 0
    cur_key = None
    cur_start = 0
    i = 0
    while i < len(sddl):
        c = sddl[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif depth == 0 and c in "OGDS" and i + 1 < len(sddl) \
                and sddl[i + 1] == ":":
            if cur_key is not None:
                out.append((cur_key, sddl[cur_start:i]))
            cur_key = c
            cur_start = i + 2
            i += 1
        i += 1
    if cur_key is not None:
        out.append((cur_key, sddl[cur_start:]))
    return out


def _parse_acl_sddl(body: str) -> tuple[str, list[Ace]]:
    flags = (body.split("(", 1)[0] if "(" in body else body).upper()
    # DACL/SACL control flags are a strict token sequence
    rest = flags
    for tok in ("P", "AR", "AI"):
        rest = rest.replace(tok, "", 1)
    if rest:
        raise ValueError(f"bad ACL control flags {flags!r}")
    aces = []
    depth = 0
    start = 0
    i = len(body.split("(", 1)[0]) if "(" in body else len(body)
    while i < len(body):
        c = body[i]
        if c == "(":
            if depth == 0:
                start = i
            depth += 1
        elif c == ")":
            depth -= 1
            if depth < 0:
                raise ValueError("unbalanced parens in ACL")
            if depth == 0:
                aces.append(Ace.from_sddl(body[start:i + 1]))
        elif depth == 0:
            # anything at depth 0 after the flags prefix is junk — an
            # untrusted-SDDL injection attempt, not grammar
            raise ValueError(f"unexpected {c!r} in ACL body")
        i += 1
    if depth != 0:
        raise ValueError("unbalanced parens in ACL")
    return flags, aces
