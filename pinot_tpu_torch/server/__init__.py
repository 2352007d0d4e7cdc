"""The server tier: the server instance and its segment data managers,
the query schedulers, admission in front of the executor and the worker
pool its segment fan-out runs on."""
