"""The LM data pipeline: training-data selection as an indexed HAIL query."""
