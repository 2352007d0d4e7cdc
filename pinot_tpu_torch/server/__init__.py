"""The server tier: admission in front of the executor and the worker
pool its segment fan-out runs on."""
