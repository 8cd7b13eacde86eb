"""Docs-vs-bench consistency gate.

Round 3 shipped a stale throughput claim in docs/migration.md (a
debunked short-loop timer artifact, 15.97M cc/s, survived after
README/CHANGELOG were corrected). This test greps every prose surface
for the known-debunked figures so a stale number can never outlive its
correction again. Figures may only appear in an explicitly-marked
debunking context (the README's timer-hardening note).
"""

import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Every figure the hardened timer debunked as physically impossible
# (bench.py _dev_time_per_iter rationale), plus retired setup claims.
DEBUNKED = [
    r"15\.97\s*M",          # r3 short-loop cc/s artifact
    r"48\.5\s*M",           # r2 min-of-5 artifact
    r"1\.125x its speed-of-light",
]

# Lines that *explain* the debunking are allowed to cite the figures.
ALLOW = re.compile(
    r"physically impossible|debunk|artifact|hardened|could read|wrong",
    re.IGNORECASE)

PROSE = [
    p for pat in ("*.md", "docs/*.md", "examples/*.py", "examples/*.md")
    for p in ROOT.glob(pat)
    if p.name not in ("ADVICE.md", "PROGRESS.jsonl")
]


def test_no_stale_perf_claims():
    assert PROSE, "doc glob found nothing — repo layout changed?"
    offenders = []
    for path in PROSE:
        for lineno, line in enumerate(
                path.read_text(errors="replace").splitlines(), 1):
            for pat in DEBUNKED:
                if re.search(pat, line) and not ALLOW.search(line):
                    offenders.append(f"{path.relative_to(ROOT)}:{lineno}: "
                                     f"{line.strip()}")
    assert not offenders, (
        "stale debunked performance figures in docs:\n" +
        "\n".join(offenders))


def test_migration_md_matches_latest_bench():
    """Speed figures live in PERF.md, next to the card they were taken
    on: migration.md quotes no correlations/s figure of its own, so it
    cannot drift from the measurements."""
    text = (ROOT / "docs" / "migration.md").read_text()
    m = re.search(r"([\d.]+)\s*M correlations/s", text)
    assert m is None, (
        f"migration.md quotes {m.group(0)!r}; point to PERF.md instead")
    assert "PERF.md" in text, "migration.md should point to PERF.md"
