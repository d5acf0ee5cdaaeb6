"""Hash gadgets (host and in-circuit)."""
