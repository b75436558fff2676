"""Host data: the pickled dataset, shape-bucket batching, collation and augmentation."""
