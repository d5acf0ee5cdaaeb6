"""Standard gadgets the port needs: MiMC and the Merkle proof."""
