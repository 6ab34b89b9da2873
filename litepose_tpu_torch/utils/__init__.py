"""Run directories, loggers and the AP table of the command-line tools."""
