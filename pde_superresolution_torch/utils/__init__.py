"""Host-side utilities: JSONL metrics and TensorBoard scalar events."""
