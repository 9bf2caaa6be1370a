"""Small host-side helpers of the serving runtime."""
