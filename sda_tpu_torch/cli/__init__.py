"""L7: command-line interfaces (`sda` agent tool, `sdad` server daemon)."""
