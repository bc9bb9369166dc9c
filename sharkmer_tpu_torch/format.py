"""Human-readable formatting helpers (upstream sharkmer src/format.rs)."""

from __future__ import annotations


def format_count(n: int) -> str:
    """Comma-separated thousands, e.g. 1,234,567."""
    return f"{n:,}"


def format_bytes(n: int) -> str:
    """1024-based units with one decimal, e.g. '1.2 GB'."""
    kb, mb, gb = 1024.0, 1024.0**2, 1024.0**3
    b = float(n)
    if b < kb:
        return f"{n} B"
    if b < mb:
        return f"{b / kb:.1f} KB"
    if b < gb:
        return f"{b / mb:.1f} MB"
    return f"{b / gb:.1f} GB"


def format_duration(seconds: float) -> str:
    """'12.3s', '1m 23s', '1h 5m'."""
    if seconds < 60.0:
        return f"{seconds:.1f}s"
    if seconds < 3600.0:
        mins = int(seconds // 60)
        return f"{mins}m {seconds - mins * 60:.0f}s"
    hours = int(seconds // 3600)
    mins = int((seconds - hours * 3600) // 60)
    return f"{hours}h {mins}m"
