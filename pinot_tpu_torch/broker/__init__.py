"""The broker tier: the request handler (the SQL front door, routing,
scatter / gather), the table quota, gapfill, and the reduce that merges
the servers' DataTables."""
