"""Host-side tools."""
