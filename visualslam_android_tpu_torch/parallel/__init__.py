"""Multi-stream tracking: S camera streams against one shared map."""
