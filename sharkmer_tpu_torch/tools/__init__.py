"""Offline tools that need no accelerator (synthetic read generation)."""
