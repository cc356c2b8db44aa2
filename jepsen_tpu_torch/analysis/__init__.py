"""Host-side history analysis."""
