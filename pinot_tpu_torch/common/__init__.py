"""Host-side building blocks shared by the engine and the executors."""
