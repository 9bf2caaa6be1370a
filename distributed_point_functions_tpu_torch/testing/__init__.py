"""Test support for the port: the fixed hybrid keyset (`encrypt_decrypt`)."""
