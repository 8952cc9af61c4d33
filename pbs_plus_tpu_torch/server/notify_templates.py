"""Notification templates: event → rendered subject/body text.

Reference capability: internal/server/notification/templates.go +
build/package/server/templates/*.hbs — 28 handlebars templates installed
into PBS so every notification is human-readable, overridable by the
operator.  Here: a minimal mustache-style renderer ({{var}}, {{#if v}},
{{#each list}} with {{this}}/{{@key}} fields) over a built-in template
set, with a file override dir (<state>/templates/<name>.tmpl wins).

A copy of the JAX package's ``server/notify_templates.py``, its code
byte for byte."""

from __future__ import annotations

import os
import re
from typing import Any

_VAR = re.compile(r"\{\{\s*([@\w.]+)\s*\}\}")
_IF = re.compile(r"\{\{#if\s+([\w.]+)\s*\}\}(.*?)\{\{/if\}\}", re.S)
_EACH = re.compile(r"\{\{#each\s+([\w.]+)\s*\}\}(.*?)\{\{/each\}\}", re.S)


def _lookup(ctx: Any, dotted: str):
    cur = ctx
    for part in dotted.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part, "")
        else:
            cur = getattr(cur, part, "")
    return cur


def render(template: str, ctx: dict) -> str:
    """Render one template against ``ctx`` (depth-1 sections, which is
    all the built-in set needs)."""
    def do_each(m: "re.Match") -> str:
        items = _lookup(ctx, m.group(1)) or []
        out = []
        body = m.group(2)
        for item in items:
            sub = dict(ctx)
            if isinstance(item, dict):
                sub.update(item)
            sub["this"] = item
            out.append(render(body, sub))      # sections nest inside each
        return "".join(out)

    def do_if(m: "re.Match") -> str:
        return render(m.group(2), ctx) if _lookup(ctx, m.group(1)) else ""

    s = _EACH.sub(do_each, template)
    s = _IF.sub(do_if, s)
    return _render_flat(s, ctx)


def _render_flat(s: str, ctx: dict) -> str:
    return _VAR.sub(lambda m: str(_lookup(ctx, m.group(1))), s)


# -- built-in template set (override via <template_dir>/<name>.tmpl) -------

DEFAULT_TEMPLATES: dict[str, str] = {
    "backup-success": (
        "Backup {{job}} succeeded\n"
        "Snapshot: {{snapshot}}\n"
        "Entries: {{entries}}  Files: {{files}}  Bytes: {{bytes}}\n"
        "Duration: {{duration}}s\n"),
    "backup-warnings": (
        "Backup {{job}} finished WITH WARNINGS\n"
        "Snapshot: {{snapshot}}\n"
        "{{error_count}} file error(s):\n"
        "{{#each errors}} - {{this}}\n{{/each}}"),
    "backup-error": (
        "Backup {{job}} FAILED\n"
        "Error: {{error}}\n"
        "{{#if snapshot}}Partial snapshot: {{snapshot}}\n{{/if}}"),
    "restore-success": (
        "Restore {{job}} completed\n"
        "Snapshot: {{snapshot}}\nDestination: {{destination}}\n"),
    "restore-error": (
        "Restore {{job}} FAILED\nError: {{error}}\n"),
    "verification-report": (
        "Verification {{job}}: {{checked}} file(s) checked\n"
        "{{#if corrupt_count}}CORRUPT FILES: {{corrupt_count}}\n"
        "{{#each corrupt}} - {{this}}\n{{/each}}{{/if}}"
        "{{#if ok}}All sampled files verified OK\n{{/if}}"),
    "batch-summary": (
        "Run summary: {{total}} job(s) — {{ok_count}} ok, "
        "{{bad_count}} not ok\n"
        "{{#each results}} - {{job}}: {{status}}"
        "{{#if detail}} ({{detail}}){{/if}}\n{{/each}}"),
    "alert-stale-backup": (
        "ALERT: backup {{job}} is stale\n"
        "Last successful run: {{last_run}}\n"
        "Schedule: {{schedule}}\n"),
    "alert-backup-failing": (
        "ALERT: backup {{job}} is failing\nLast error: {{error}}\n"),
    "alert-target-offline": (
        "ALERT: target {{target}} is offline\n"
        "The agent has no live control session.\n"),
    "alert-datastore-usage": (
        "ALERT: datastore usage at {{percent}}%\n"
        "{{used}} of {{total}} bytes used.\n"),
    "agent-updated": (
        "Agent {{host}} updated to {{version}}\n"),
    "agent-update-rollback": (
        "Agent {{host}} ROLLED BACK a failed update to {{version}}\n"),
}


class TemplateSet:
    def __init__(self, template_dir: str | None = None):
        self.template_dir = template_dir

    def get(self, name: str) -> str:
        if self.template_dir:
            p = os.path.join(self.template_dir, f"{name}.tmpl")
            try:
                with open(p) as f:
                    return f.read()
            except OSError:
                pass
        try:
            return DEFAULT_TEMPLATES[name]
        except KeyError:
            raise KeyError(f"unknown notification template {name!r}")

    def render(self, name: str, ctx: dict) -> str:
        return render(self.get(name), ctx)
