"""llama-server: an HTTP front end on the standard library over the
continuous-batching scheduler, chat templates and tool-call parsing."""
