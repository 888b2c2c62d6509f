"""The in-process halves of the RPC plane the serving path needs."""
