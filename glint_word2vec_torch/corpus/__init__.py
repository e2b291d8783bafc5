"""Host-side corpus structures of the port."""
