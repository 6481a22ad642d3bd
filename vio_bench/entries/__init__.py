"""One module per entry point of the port that a traffic mix can name
(its ``entry``): ``replay`` (the chunked server)."""
