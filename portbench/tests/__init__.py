"""The benchmark's tests (see conftest.py)."""
