"""Host-side decoders of the port's device results (numpy only)."""
