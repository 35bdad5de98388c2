"""Host-side data of the port: frame readers and the evaluation datasets."""
