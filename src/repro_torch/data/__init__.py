"""Procedural datasets made with numpy from a seed (no download)."""
