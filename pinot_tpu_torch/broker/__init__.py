"""The broker tier: the reduce that merges the servers' DataTables."""
