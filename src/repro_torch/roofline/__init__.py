"""Analytic roofline: per-component FLOPs and bytes, and the record each dry-run cell writes."""
