"""Proving backends: Groth16 prove (backend/groth16.py)."""
