"""Host-side helpers of the CLIs."""
