"""The plain reference the benchmark holds the port against (``model.py``)."""
