"""Host-side image helpers."""
