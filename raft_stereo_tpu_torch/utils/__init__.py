"""Weight conversion helpers of the port."""
