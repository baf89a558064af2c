"""Host-side core of the port: error checks and device resolution."""
